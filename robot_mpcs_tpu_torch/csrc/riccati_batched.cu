// General batched Riccati backward sweep, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel robot_mpcs_tpu/ops/riccati_pallas.py:189
// (riccati_backward_batched, body _make_kernel, stage solve _ldl_solve).
// Per lane it runs the backward recursion over the N stages of the horizon
// for arbitrary per-stage dynamics Jacobians A (NX x NX), B (NX x NW):
//
//   Qxx = lxx + A^T V A,  Qxw = lxw + A^T V B,  Qww = lww + B^T V B + reg I,
//   qx  = lx  + A^T vx,   qw  = lw  + B^T vx,
//   LDL^T of Qww solves [qw | Qxw^T]:  k_ff = -Qww^-1 qw,  K = -Qww^-1 Qxw^T,
//   vx' = qx + Qxw k + K^T qw + K^T Qww k,
//   V'  = Qxx + Qxw K + (Qxw K)^T + K^T Qww K,  then V' = (V' + V'^T) / 2.
//
// A pivot d <= 1e-12 (or NaN) is replaced by 1, the stage's gains are
// multiplied by 0 and the lane is marked failed, exactly as the TPU kernel
// does; the value update still runs with the zero gains. The terminal value
// function is zero (the solver sets A = B = 0 at the last stage).
//
// A and B come with a batch stride in floats: N*NX*NX (resp. N*NX*NW) for
// per-lane Jacobians (diff-drive), 0 for batch-constant ones.
//
// What bounds it on an H100: bytes, then latency. Per stage a lane reads
// lx, lw, lxx, lxw, lww and (per lane) A, B, and writes k_ff and K: 192
// floats = 768 B at NX=8, NW=2 (boxer), against O(NX^3) flops, far below the
// fp32 rate. The stages of a lane are sequential, so what is left is one
// stage's latency times N, hidden only by the lanes in flight; the fleet's
// rescue tier runs boxer at B = 128.
//
// The design: a team of T threads per lane (T = 16 at NX <= 8, a warp at
// NX=14), 128 / T lanes per 128-thread block. Per stage the team
//   1. has the stage's block in shared memory already: copied with 4-byte
//      cp.async by the whole team, consecutive threads on consecutive floats
//      (coalesced), while the previous stages computed (three stage
//      buffers), from the solver's (B, N, ...) tensors in place;
//   2. forms W = V [A | B] and [qx | qw], entries spread over the team;
//   3. forms Qxx = lxx + A^T W_A, Qxw = lxw + A^T W_B, Qww = lww + B^T W_B
//      + reg I the same way;
//   4. solves: threads 0..NX each factor Qww in registers and solve their
//      own column of [qw | Qxw^T] (ldl_solve in riccati_common.cuh), then
//      form their column of Qww Y;
//   5. updates the value function, vx' and V's upper triangle spread over
//      the team, each entry averaged with its transpose's.
// Members synchronise with __syncwarp only (a team never spans two warps).
// Batch-constant A and B (stride 0) are copied into shared memory once per
// block for the whole horizon, before the stage loop (the block's one
// __syncthreads); a horizon too long for shared memory is staged by each
// team like per-lane dynamics. The stage buffers, carry and workspace are
// ~3.4 KB of shared memory per boxer lane, so each thread holds a few
// scalars and many teams fit on an SM to hide each other's latency.
//
// No tensor cores: the sweep computes in full f32 (the solver's ground rule:
// lower-precision products stalled convergence), mma/wgmma would be TF32 or
// lower, and a lane's matrices (8 x 8) are far below a 64-row tile.

#include "riccati_common.cuh"

namespace {

using namespace riccati;

// Per-lane shared memory, in floats: DEPTH stage buffers (lx, lw, lxx, lxw,
// lww, A, B, as one (B, N, ...) stage of each tensor holds them), the carry
// V (row stride VS) and vx, W = V [A | B] and the Q blocks (row stride WS:
// rows 0..NX-1 hold [Qxx | Qxw], rows NX.. hold Qww in columns NX..), [qx |
// qw], the gains Y = [k_ff | K] and Qww Y, both (NW, 1 + NX).
template <int NX, int NW, int DEPTH>
struct GeneralLayout {
  static constexpr int M = 1 + NX, NV = NX + NW;
  static constexpr int LX = 0, LW = LX + NX, LXX = LW + NW, LXW = LXX + NX * NX,
                       LWW = LXW + NX * NW, A = LWW + NW * NW, BM = A + NX * NX,
                       STAGE = BM + NX * NW;
  static constexpr int VS = odd(NX), WS = odd(NV);
  static constexpr int V = DEPTH * STAGE, VX = V + NX * VS, W = VX + NX, Q = W + NX * WS,
                       QV = Q + NV * WS, Y = QV + NV, QY = Y + NW * M, FLOATS = QY + NW * M;
};

template <int NX, int NW, int T>
__global__ void __launch_bounds__(kBlockThreads) riccati_batched_kernel(
    const float* __restrict__ lx, const float* __restrict__ lw,
    const float* __restrict__ lxx, const float* __restrict__ lxw,
    const float* __restrict__ lww, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ reg,
    float* __restrict__ kff, float* __restrict__ Kout,
    unsigned char* __restrict__ failed, int B, int N, long long a_stride,
    long long b_stride, int shared_ab) {
  // stage buffers: stages k-1 and k-2 in flight while stage k computes,
  // unless three pass the 48 KB of static shared memory ((14, 7)); three
  // measured faster than two at boxer's shapes, four no faster than three
  constexpr int DEPTH =
      kBlockThreads / T * GeneralLayout<NX, NW, 3>::FLOATS * 4 <= 48 * 1024 ? 3 : 2;
  using Lay = GeneralLayout<NX, NW, DEPTH>;
  constexpr int M = Lay::M;  // rhs columns of the stage solve: [qw | Qxw^T]
  constexpr int NV = Lay::NV;
  constexpr int LANES = kBlockThreads / T;
  constexpr int VS = Lay::VS, WS = Lay::WS;
  static_assert(32 % T == 0 && M <= T, "a team within one warp, a thread per solve column");

  // with shared_ab: A (N, NX, NX) then B (N, NX, NW), once per block
  extern __shared__ float horizon[];
  __shared__ float smem[LANES * Lay::FLOATS];
  const int t = threadIdx.x % T;
  const int lane = blockIdx.x * LANES + threadIdx.x / T;
  const bool live = lane < B;
  const int b = live ? lane : B - 1;  // a team past the batch mirrors the last lane, stores nothing
  float* sm = smem + (threadIdx.x / T) * Lay::FLOATS;
  float* V = sm + Lay::V;
  float* vx = sm + Lay::VX;
  float* W = sm + Lay::W;
  float* Q = sm + Lay::Q;
  float* QV = sm + Lay::QV;
  float* Y = sm + Lay::Y;
  float* QY = sm + Lay::QY;
  const float* A_lane = A + static_cast<long long>(b) * a_stride;
  const float* B_lane = Bm + static_cast<long long>(b) * b_stride;

  auto load_stage = [&](int k) {  // stage k into buffer k % DEPTH
    const size_t s = static_cast<size_t>(b) * N + k;
    float* dst = sm + (k % DEPTH) * Lay::STAGE;
    team_copy<NX, T>(dst + Lay::LX, lx + s * NX, t);
    team_copy<NW, T>(dst + Lay::LW, lw + s * NW, t);
    team_copy<NX * NX, T>(dst + Lay::LXX, lxx + s * NX * NX, t);
    team_copy<NX * NW, T>(dst + Lay::LXW, lxw + s * NX * NW, t);
    team_copy<NW * NW, T>(dst + Lay::LWW, lww + s * NW * NW, t);
    if (!shared_ab) {
      team_copy<NX * NX, T>(dst + Lay::A, A_lane + static_cast<size_t>(k) * NX * NX, t);
      team_copy<NX * NW, T>(dst + Lay::BM, B_lane + static_cast<size_t>(k) * NX * NW, t);
    }
  };

  for (int e = t; e < NX * VS; e += T) V[e] = 0.f;
  for (int e = t; e < NX; e += T) vx[e] = 0.f;
  const float r = reg[b];
  if (shared_ab) {
    for (int e = threadIdx.x; e < N * NX * NX; e += kBlockThreads) cp_async4(horizon + e, A + e);
    float* hB = horizon + static_cast<size_t>(N) * NX * NX;
    for (int e = threadIdx.x; e < N * NX * NW; e += kBlockThreads) cp_async4(hB + e, Bm + e);
  }
#pragma unroll
  for (int j = 1; j <= DEPTH; ++j) {
    if (N - j >= 0) load_stage(N - j);
    cp_async_commit();
  }
  cp_async_wait<DEPTH - 1>();
  __syncthreads();  // the shared horizon is read by every team of the block

  float lane_bad = 0.f;
  for (int k = N - 1; k >= 0; --k) {
    const float* S = sm + (k % DEPTH) * Lay::STAGE;
    const float* LX = S + Lay::LX;
    const float* LW = S + Lay::LW;
    const float* LXX = S + Lay::LXX;
    const float* LXW = S + Lay::LXW;
    const float* LWW = S + Lay::LWW;
    const float* AK = shared_ab ? horizon + static_cast<size_t>(k) * NX * NX : S + Lay::A;
    const float* BK = shared_ab ? horizon + static_cast<size_t>(N) * NX * NX +
                                      static_cast<size_t>(k) * NX * NW
                                : S + Lay::BM;
    auto AB = [&](int q, int j) { return j < NX ? AK[q * NX + j] : BK[q * NW + j - NX]; };  // [A | B]

    // 1. W = V [A | B] (columns :NX are V A, NX: are U = V B);
    //    [qx | qw] = [lx | lw] + [A | B]^T vx
    constexpr int E1 = NX * NV + NV;
#pragma unroll
    for (int q = 0; q < ceil_div(E1, T); ++q) {
      const int e = t + q * T;
      if (e < NX * NV) {
        const int i = e / NV, j = e % NV;
        float acc = V[i * VS] * AB(0, j);
#pragma unroll
        for (int p = 1; p < NX; ++p) acc = acc + V[i * VS + p] * AB(p, j);
        W[i * WS + j] = acc;
      } else if (e < E1) {
        const int j = e - NX * NV;
        float acc = j < NX ? LX[j] : LW[j - NX];
#pragma unroll
        for (int p = 0; p < NX; ++p) acc = acc + AB(p, j) * vx[p];
        QV[j] = acc;
      }
    }
    __syncwarp();

    // 2. Qxx = lxx + A^T (V A), Qxw = lxw + A^T U, Qww = lww + B^T U + reg I:
    //    row i of [A | B]^T times column j of W
    constexpr int E2 = NX * NV + NW * NW;
#pragma unroll
    for (int q = 0; q < ceil_div(E2, T); ++q) {
      const int e = t + q * T;
      if (e < E2) {
        int i, j;
        float base;
        if (e < NX * NV) {
          i = e / NV;
          j = e % NV;
          base = j < NX ? LXX[i * NX + j] : LXW[i * NW + j - NX];
        } else {
          i = NX + (e - NX * NV) / NW;
          j = NX + (e - NX * NV) % NW;
          base = LWW[(i - NX) * NW + j - NX];
        }
        float acc = AB(0, i) * W[j];
#pragma unroll
        for (int p = 1; p < NX; ++p) acc = acc + AB(p, i) * W[p * WS + j];
        float v = base + acc;
        if (i >= NX && i == j) v = v + r;
        Q[i * WS + j] = v;
      }
    }
    __syncwarp();

    // 3. the stage solve of column t of [qw | Qxw^T] (gains zero for a failed
    //    stage; every solving thread sees the same pivots), then column t of
    //    Qww Y
    const float* QWW = Q + NX * WS + NX;
    float bad = 0.f;
    if (t < M) {
      float y[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) y[w] = t == 0 ? QV[NX + w] : Q[(t - 1) * WS + NX + w];
      bad = ldl_solve<NW, true>(QWW, WS, y);
      const float good = 1.f - bad;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        y[w] = -y[w] * good;
        Y[w * M + t] = y[w];
      }
#pragma unroll
      for (int v = 0; v < NW; ++v) {
        float acc = QWW[v * WS] * y[0];
#pragma unroll
        for (int p = 1; p < NW; ++p) acc = acc + QWW[v * WS + p] * y[p];
        QY[v * M + t] = acc;
      }
    }
    lane_bad = fmaxf(lane_bad, bad);
    __syncwarp();

    // 4. full-form value update into registers, V' averaged with its
    //    transpose entry by entry
    auto Qxw = [&](int i, int w) { return Q[i * WS + NX + w]; };
    constexpr int NE = NX + NX * (NX + 1) / 2;
    float out[ceil_div(NE, T)];
#pragma unroll
    for (int q = 0; q < ceil_div(NE, T); ++q) {
      const int e = t + q * T;
      if (e < NX) {
        float acc = QV[e];
#pragma unroll
        for (int w = 0; w < NW; ++w)
          acc = acc + Qxw(e, w) * Y[w * M] + Y[w * M + 1 + e] * QV[NX + w] +
                Y[w * M + 1 + e] * QY[w * M];
        out[q] = acc;
      } else if (e < NE) {
        int i, c;
        upper_entry<NX>(e - NX, i, c);
        float vic = Q[i * WS + c];
        float vci = Q[c * WS + i];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float* Yw = Y + w * M + 1;
          const float* QYw = QY + w * M + 1;
          vic = vic + Qxw(i, w) * Yw[c] + Yw[i] * Qxw(c, w) + Yw[i] * QYw[c];
          vci = vci + Qxw(c, w) * Yw[i] + Yw[c] * Qxw(i, w) + Yw[c] * QYw[i];
        }
        out[q] = 0.5f * (vic + vci);
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

template <int NX, int NW, int T>
int launch(const float* lx, const float* lw, const float* lxx, const float* lxw,
           const float* lww, const float* A, const float* Bm, const float* reg,
           float* kff, float* K, unsigned char* failed, int B, int N,
           long long a_stride, long long b_stride, cudaStream_t stream) {
  auto kernel = riccati_batched_kernel<NX, NW, T>;
  // dynamic shared memory a block may take beside its static part, raised
  // once from the default 48 KB to the card's opt-in maximum
  static const int dynamic_limit = [&] {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    cudaFuncGetAttributes(&attr, kernel);
    const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    return limit;
  }();
  size_t horizon = 0;
  if (a_stride == 0 && b_stride == 0) {
    horizon = static_cast<size_t>(N) * (NX * NX + NX * NW) * sizeof(float);
    if (horizon > static_cast<size_t>(dynamic_limit)) horizon = 0;
  }
  const int blocks = ceil_div(B, kBlockThreads / T);
  kernel<<<blocks, kBlockThreads, horizon, stream>>>(
      lx, lw, lxx, lxw, lww, A, Bm, reg, kff, K, failed, B, N, a_stride, b_stride,
      horizon > 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// contiguous f32 tensors: the (B, N, ...) stage blocks, A and Bm with the
// given batch strides in floats (0 = one (N, ...) block shared by every
// lane), reg (B,), and a (B,) bool `failed`. Returns cudaGetLastError()
// after the launch, or -1 (no cudaError_t value) for an (nx, nw) with no
// instantiation: the RICCATI_CASE lines below are the one list of shapes the
// kernel supports, each with its team size T.
extern "C" int riccati_batched_launch(
    const float* lx, const float* lw, const float* lxx, const float* lxw,
    const float* lww, const float* A, const float* Bm, const float* reg,
    float* kff, float* K, unsigned char* failed, int B, int N, int nx, int nw,
    long long a_stride, long long b_stride, cudaStream_t stream) {
  if (B == 0 || N == 0) return 0;
#define RICCATI_CASE(NX_, NW_, T_)                                              \
  if (nx == NX_ && nw == NW_)                                                  \
    return launch<NX_, NW_, T_>(lx, lw, lxx, lxw, lww, A, Bm, reg, kff, K, failed, \
                                B, N, a_stride, b_stride, stream);
  RICCATI_CASE(6, 3, 16)   // pointRobot-sized test dims
  RICCATI_CASE(14, 7, 32)  // panda-sized test dims
  RICCATI_CASE(8, 2, 16)   // boxer
  RICCATI_CASE(8, 3, 16)   // boxer with slack
#undef RICCATI_CASE
  return -1;
}
