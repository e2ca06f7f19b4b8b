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
// per-lane Jacobians (diff-drive), 0 for batch-constant ones. With stride 0
// every thread of a warp reads the same address, a broadcast from L1; no
// broadcast copy is ever made in device memory.
//
// What bounds it on an H100: bytes. Per stage a lane reads lx, lw, lxx, lxw,
// lww and (batched) A, B, and writes k_ff and K: 192 floats = 768 B at
// NX=8, NW=2 (boxer), 763 floats = 3,052 B at NX=14, NW=7, against
// O(NX^3) flops, far below the fp32 rate. The stage loop is sequential, the
// lanes independent, so the kernel is one thread per lane with the loop
// inside the thread, reading the solver's (B, N, ...) tensors in place (no
// transposes around the call; each thread strides by a whole lane's block,
// so loads are not coalesced). Blocks are one warp (32 threads): a boxer
// fleet is 1,024 lanes, which as 128-thread blocks would occupy 8 of the 132
// SMs; as 32-thread blocks it occupies 32. The carry V (NX*NX floats), the
// stage's A, Qxx and the solve's workspace are register arrays, fully
// unrolled over the template sizes; at NX=14 they exceed 255 registers and
// spill to local memory (L1-cached). A warp per lane with coalesced loads,
// or the carry in shared memory, is later work; this is the right, simple
// version.

#include <cuda_runtime.h>

namespace {

constexpr float kPivotTiny = 1e-12f;
constexpr int kThreads = 32;

template <int NX, int NW>
__global__ void __launch_bounds__(kThreads) riccati_batched_kernel(
    const float* __restrict__ lx, const float* __restrict__ lw,
    const float* __restrict__ lxx, const float* __restrict__ lxw,
    const float* __restrict__ lww, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ reg,
    float* __restrict__ kff, float* __restrict__ Kout,
    unsigned char* __restrict__ failed, int B, int N, long long a_stride,
    long long b_stride) {
  constexpr int M = 1 + NX;  // rhs columns of the stage solve: [qw | Qxw^T]

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float V[NX][NX];
  float vx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    vx[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NX; ++c) V[i][c] = 0.f;
  }
  const float r = reg[b];
  const float* A_lane = A + static_cast<long long>(b) * a_stride;
  const float* B_lane = Bm + static_cast<long long>(b) * b_stride;
  float lane_bad = 0.f;

  for (int k = N - 1; k >= 0; --k) {
    const size_t s = static_cast<size_t>(b) * N + k;
    const float* LX = lx + s * NX;
    const float* LW = lw + s * NW;
    const float* LXX = lxx + s * NX * NX;
    const float* LXW = lxw + s * NX * NW;
    const float* LWW = lww + s * NW * NW;
    const float* AK = A_lane + static_cast<size_t>(k) * NX * NX;
    const float* BK = B_lane + static_cast<size_t>(k) * NX * NW;

    float Ar[NX][NX];
    float Br[NX][NW];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int c = 0; c < NX; ++c) Ar[i][c] = __ldg(AK + i * NX + c);
#pragma unroll
      for (int c = 0; c < NW; ++c) Br[i][c] = __ldg(BK + i * NW + c);
    }

    // U = V B (NX x NW); qx = lx + A^T vx; qw = lw + B^T vx
    float U[NX][NW];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        float acc = V[i][0] * Br[0][c];
#pragma unroll
        for (int q = 1; q < NX; ++q) acc = acc + V[i][q] * Br[q][c];
        U[i][c] = acc;
      }
    }
    float qx[NX];
    float qw[NW];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = LX[i];
#pragma unroll
      for (int q = 0; q < NX; ++q) acc = acc + Ar[q][i] * vx[q];
      qx[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      float acc = LW[i];
#pragma unroll
      for (int q = 0; q < NX; ++q) acc = acc + Br[q][i] * vx[q];
      qw[i] = acc;
    }

    // Qxx = lxx + A^T (V A), one column of V A at a time
    float Qxx[NX][NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      float t[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = V[i][0] * Ar[0][c];
#pragma unroll
        for (int q = 1; q < NX; ++q) acc = acc + V[i][q] * Ar[q][c];
        t[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = Ar[0][i] * t[0];
#pragma unroll
        for (int q = 1; q < NX; ++q) acc = acc + Ar[q][i] * t[q];
        Qxx[i][c] = LXX[i * NX + c] + acc;
      }
    }
    // Qxw = lxw + A^T U;  Qww = lww + B^T U + reg I
    float Qxw[NX][NW];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        float acc = Ar[0][i] * U[0][c];
#pragma unroll
        for (int q = 1; q < NX; ++q) acc = acc + Ar[q][i] * U[q][c];
        Qxw[i][c] = LXW[i * NW + c] + acc;
      }
    }
    float Qww[NW][NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        float acc = Br[0][i] * U[0][c];
#pragma unroll
        for (int q = 1; q < NX; ++q) acc = acc + Br[q][i] * U[q][c];
        Qww[i][c] = LWW[i * NW + c] + acc + (i == c ? r : 0.f);
      }
    }

    // LDL^T of Qww; NaN-aware pivot test ((d > tiny) is false for NaN)
    float L[NW][NW];
    float D[NW];
    float bad = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      float d = Qww[j][j];
#pragma unroll
      for (int q = 0; q < j; ++q) d = d - L[j][q] * L[j][q] * D[q];
      const float is_bad = d > kPivotTiny ? 0.f : 1.f;
      bad = fmaxf(bad, is_bad);
      d = d * (1.f - is_bad) + is_bad;
      D[j] = d;
      const float inv_d = 1.f / d;
#pragma unroll
      for (int i = j + 1; i < NW; ++i) {
        float acc = Qww[i][j];
#pragma unroll
        for (int q = 0; q < j; ++q) acc = acc - L[i][q] * L[j][q] * D[q];
        L[i][j] = acc * inv_d;
      }
    }
    // forward substitution L y = [qw | Qxw^T], then L^T x = D^-1 y in place
    float Y[NW][M];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float acc = c == 0 ? qw[i] : Qxw[c - 1][i];
#pragma unroll
        for (int q = 0; q < i; ++q) acc = acc - L[i][q] * Y[q][c];
        Y[i][c] = acc;
      }
    }
#pragma unroll
    for (int i = NW - 1; i >= 0; --i) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float acc = Y[i][c] / D[i];
#pragma unroll
        for (int q = i + 1; q < NW; ++q) acc = acc - L[q][i] * Y[q][c];
        Y[i][c] = acc;
      }
    }
    // gains: k_ff = Y[:, 0], K = Y[:, 1:] (zero for a failed stage)
    const float good = 1.f - bad;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int c = 0; c < M; ++c) Y[i][c] = -Y[i][c] * good;
    }

    // full-form value update; QY = Qww [k_ff | K]
    float QY[NW][M];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float acc = Qww[i][0] * Y[0][c];
#pragma unroll
        for (int q = 1; q < NW; ++q) acc = acc + Qww[i][q] * Y[q][c];
        QY[i][c] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = qx[i];
#pragma unroll
      for (int w = 0; w < NW; ++w)
        acc = acc + Qxw[i][w] * Y[w][0] + Y[w][1 + i] * qw[w] + Y[w][1 + i] * QY[w][0];
      vx[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int c = i; c < NX; ++c) {
        // V'[i][c] and V'[c][i], averaged
        float a = Qxx[i][c];
        float t = Qxx[c][i];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          a = a + Qxw[i][w] * Y[w][1 + c] + Y[w][1 + i] * Qxw[c][w] + Y[w][1 + i] * QY[w][1 + c];
          t = t + Qxw[c][w] * Y[w][1 + i] + Y[w][1 + c] * Qxw[i][w] + Y[w][1 + c] * QY[w][1 + i];
        }
        V[i][c] = 0.5f * (a + t);
        V[c][i] = V[i][c];
      }
    }

    float* KF = kff + s * NW;
    float* KK = Kout + s * NW * NX;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      KF[i] = Y[i][0];
#pragma unroll
      for (int c = 0; c < NX; ++c) KK[i * NX + c] = Y[i][1 + c];
    }
    lane_bad = fmaxf(lane_bad, bad);
  }
  failed[b] = lane_bad > 0.5f ? 1 : 0;
}

template <int NX, int NW>
int launch(const float* lx, const float* lw, const float* lxx, const float* lxw,
           const float* lww, const float* A, const float* Bm, const float* reg,
           float* kff, float* K, unsigned char* failed, int B, int N,
           long long a_stride, long long b_stride, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  riccati_batched_kernel<NX, NW><<<blocks, kThreads, 0, stream>>>(
      lx, lw, lxx, lxw, lww, A, Bm, reg, kff, K, failed, B, N, a_stride, b_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// contiguous f32 tensors: the (B, N, ...) stage blocks, A and Bm with the
// given batch strides in floats (0 = one (N, ...) block shared by every
// lane), reg (B,), and a (B,) bool `failed`. Returns cudaGetLastError()
// after the launch, or -1 (no cudaError_t value) for an (nx, nw) with no
// instantiation: the RICCATI_CASE lines below are the one list of shapes the
// kernel supports.
extern "C" int riccati_batched_launch(
    const float* lx, const float* lw, const float* lxx, const float* lxw,
    const float* lww, const float* A, const float* Bm, const float* reg,
    float* kff, float* K, unsigned char* failed, int B, int N, int nx, int nw,
    long long a_stride, long long b_stride, cudaStream_t stream) {
  if (B == 0 || N == 0) return 0;
#define RICCATI_CASE(NX_, NW_)                                                  \
  if (nx == NX_ && nw == NW_)                                                  \
    return launch<NX_, NW_>(lx, lw, lxx, lxw, lww, A, Bm, reg, kff, K, failed, \
                            B, N, a_stride, b_stride, stream);
  RICCATI_CASE(6, 3)   // pointRobot-sized test dims
  RICCATI_CASE(14, 7)  // panda-sized test dims
  RICCATI_CASE(8, 2)   // boxer
  RICCATI_CASE(8, 3)   // boxer with slack
#undef RICCATI_CASE
  return -1;
}
