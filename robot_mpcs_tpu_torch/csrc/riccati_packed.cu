// Structured (holonomic) Riccati backward sweep, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel robot_mpcs_tpu/ops/riccati_packed.py
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
// What bounds it on an H100: lanes are independent and the work per lane is
// sequential over stages, so the kernel is one thread per lane. Per stage a
// lane reads (NX + NW + NX*NX + NX*NW + NW*NW) floats (1,456 bytes for
// panda, NX=14, NW=7) and does O(NX^2 NW) flops, so at B=4096, N=20 it moves
// ~119 MB of stage inputs and ~34 MB of gains: well under a millisecond of
// HBM time at 3.35 TB/s if reads were coalesced. They are not: each thread
// walks its own (B, N, ...) rows in place, strided by a whole lane's block,
// which is what the solver hands over (no repacking transposes around the
// call, which cost more than the kernel itself on the TPU). The carry V
// (NX*NX floats) plus Qxx, Qxw and the LDL^T workspace exceed the 255
// registers a thread may hold, so they spill to local memory (L1-cached).
// Putting the carry in shared memory, or a small thread group per lane with
// coalesced loads, is later work; this version is the right and simple one.

#include <cuda_runtime.h>

namespace {

constexpr float kPivotTiny = 1e-12f;
constexpr int kThreads = 128;

template <int NX, int NW, int NS>
__global__ void __launch_bounds__(kThreads) riccati_packed_kernel(
    const float* __restrict__ lx, const float* __restrict__ lw,
    const float* __restrict__ lxx, const float* __restrict__ lxw,
    const float* __restrict__ lww, const float* __restrict__ reg,
    float* __restrict__ kff, float* __restrict__ Kout,
    unsigned char* __restrict__ failed, int B, int N, float a, float b1,
    float b2) {
  constexpr int n = NX / 2;
  constexpr int NU = NW - NS;
  constexpr int M = 1 + NX;  // rhs columns of the stage solve: [qw | Qxw^T]
  static_assert(NX % 2 == 0, "holonomic state is [q, qdot]");
  static_assert(NU == n, "one control per configuration dof");

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
  float lane_bad = 0.f;

  for (int k = N - 1; k >= 0; --k) {
    const size_t s = static_cast<size_t>(b) * N + k;
    const float* LX = lx + s * NX;
    const float* LW = lw + s * NW;
    const float* LXX = lxx + s * NX * NX;
    const float* LXW = lxw + s * NX * NW;
    const float* LWW = lww + s * NW * NW;

    // Qxx = lxx + A^T (V A), with T = V A: T[:, c] = V[:, c],
    // T[:, n+c] = a V[:, c] + V[:, n+c]; row n+i of A^T T is a T[i] + T[n+i]
    float Qxx[NX][NX];
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        const float Ti = c < n ? V[i][c] : a * V[i][c - n] + V[i][c];
        const float Tni = c < n ? V[n + i][c] : a * V[n + i][c - n] + V[n + i][c];
        Qxx[i][c] = LXX[i * NX + c] + Ti;
        Qxx[n + i][c] = LXX[(n + i) * NX + c] + a * Ti + Tni;
      }
    }
    // U = V B (control columns): U[:, c] = b1 V[:, c] + b2 V[:, n+c]
    float U[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int c = 0; c < NU; ++c) U[i][c] = b1 * V[i][c] + b2 * V[i][n + c];
    }
    // Qxw = lxw + A^T U (slack columns: lxw only)
    float Qxw[NX][NW];
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        Qxw[i][c] = LXW[i * NW + c];
        Qxw[n + i][c] = LXW[(n + i) * NW + c];
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        Qxw[i][NS + c] = LXW[i * NW + NS + c] + U[i][c];
        Qxw[n + i][NS + c] = LXW[(n + i) * NW + NS + c] + a * U[i][c] + U[n + i][c];
      }
    }
    // Qww = lww + B^T U + reg I (slack rows/columns: lww only; reg on all NW)
    float Qww[NW][NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int c = 0; c < NW; ++c) Qww[i][c] = LWW[i * NW + c];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int c = 0; c < NU; ++c)
        Qww[NS + i][NS + c] = Qww[NS + i][NS + c] + (b1 * U[i][c] + b2 * U[n + i][c]);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) Qww[i][i] = Qww[i][i] + r;
    // qx = lx + A^T vx;  qw = lw + B^T vx
    float qx[NX];
    float qw[NW];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      qx[i] = LX[i] + vx[i];
      qx[n + i] = LX[n + i] + a * vx[i] + vx[n + i];
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) qw[i] = LW[i];
#pragma unroll
    for (int c = 0; c < NU; ++c) qw[NS + c] = qw[NS + c] + b1 * vx[c] + b2 * vx[n + c];

    // LDL^T of Qww; NaN-aware pivot test ((d > tiny) is false for NaN)
    float L[NW][NW];
    float D[NW];
    float Dinv[NW];
    float bad = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      float d = Qww[j][j];
#pragma unroll
      for (int k2 = 0; k2 < j; ++k2) d = d - L[j][k2] * L[j][k2] * D[k2];
      const float is_bad = d > kPivotTiny ? 0.f : 1.f;
      bad = fmaxf(bad, is_bad);
      d = d * (1.f - is_bad) + is_bad;
      D[j] = d;
      Dinv[j] = 1.f / d;
#pragma unroll
      for (int i = j + 1; i < NW; ++i) {
        float acc = Qww[i][j];
#pragma unroll
        for (int k2 = 0; k2 < j; ++k2) acc = acc - L[i][k2] * L[j][k2] * D[k2];
        L[i][j] = acc * Dinv[j];
      }
    }
    // forward substitution on [qw | Qxw^T], then back substitution in place
    float Y[NW][M];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float acc = c == 0 ? qw[i] : Qxw[c - 1][i];
#pragma unroll
        for (int k2 = 0; k2 < i; ++k2) acc = acc - L[i][k2] * Y[k2][c];
        Y[i][c] = acc;
      }
    }
#pragma unroll
    for (int i = NW - 1; i >= 0; --i) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float acc = Y[i][c] * Dinv[i];
#pragma unroll
        for (int k2 = i + 1; k2 < NW; ++k2) acc = acc - L[k2][i] * Y[k2][c];
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

    // value update, Schur form: vx' = qx + Qxw k_ff; V' = Qxx + Qxw K
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = qx[i];
#pragma unroll
      for (int w = 0; w < NW; ++w) acc = acc + Qxw[i][w] * Y[w][0];
      vx[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int c = i; c < NX; ++c) {
        float acc = Qxx[i][c];
#pragma unroll
        for (int w = 0; w < NW; ++w) acc = acc + Qxw[i][w] * Y[w][1 + c];
        V[i][c] = acc;
        V[c][i] = acc;
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

template <int NX, int NW, int NS>
int launch(const float* lx, const float* lw, const float* lxx, const float* lxw,
           const float* lww, const float* reg, float* kff, float* K,
           unsigned char* failed, int B, int N, float a, float b1, float b2,
           cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  riccati_packed_kernel<NX, NW, NS><<<blocks, kThreads, 0, stream>>>(
      lx, lw, lxx, lxw, lww, reg, kff, K, failed, B, N, a, b1, b2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// contiguous f32 (B, N, ...) tensors; `failed` is a (B,) bool tensor. Returns
// cudaGetLastError() after the launch, or -1 (no cudaError_t value) for a
// (nx, nw, ns) with no instantiation: the RICCATI_CASE lines below are the
// one list of shapes the kernel supports.
extern "C" int riccati_packed_launch(
    const float* lx, const float* lw, const float* lxx, const float* lxw,
    const float* lww, const float* reg, float* kff, float* K,
    unsigned char* failed, int B, int N, int nx, int nw, int ns, float a,
    float b1, float b2, cudaStream_t stream) {
  if (B == 0 || N == 0) return 0;
#define RICCATI_CASE(NX_, NW_, NS_)                                             \
  if (nx == NX_ && nw == NW_ && ns == NS_)                                     \
    return launch<NX_, NW_, NS_>(lx, lw, lxx, lxw, lww, reg, kff, K, failed, B, \
                                 N, a, b1, b2, stream);
  RICCATI_CASE(6, 3, 0)   // pointRobot
  RICCATI_CASE(6, 4, 1)   // pointRobot with slack
  RICCATI_CASE(14, 7, 0)  // panda
  RICCATI_CASE(14, 8, 1)  // panda with slack
#undef RICCATI_CASE
  return -1;
}
