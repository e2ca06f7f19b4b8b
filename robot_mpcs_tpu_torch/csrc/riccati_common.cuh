// Device helpers shared by the two Riccati sweep kernels (riccati_packed.cu,
// riccati_batched.cu): the thread-team geometry, 4-byte cp.async staging of a
// lane's stage block, index maps that spread a triangle over a team, and the
// LDL^T stage solve of one right-hand column.
#pragma once

#include <cuda_runtime.h>

namespace riccati {

constexpr float kPivotTiny = 1e-12f;
// threads per block; a block holds kBlockThreads / T lanes of T threads each
constexpr int kBlockThreads = 128;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
// an odd row stride: a team walking one column down the rows of a matrix in
// shared memory touches as many banks as rows
__host__ __device__ constexpr int odd(int x) { return x | 1; }

// 4-byte asynchronous copy global -> shared. Larger copies (and TMA) need
// 16-byte aligned addresses, which the solver's per-stage blocks are not
// (lw, lxw and lww of an odd stage start at 4-byte offsets at panda's sizes).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most PENDING of this thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Thread t of a team of T copies floats t, t + T, ... of a contiguous block
// of COUNT floats: a warp's copy covers consecutive addresses (coalesced).
template <int COUNT, int T>
__device__ __forceinline__ void team_copy(float* dst, const float* src, int t) {
#pragma unroll
  for (int r = 0; r < ceil_div(COUNT, T); ++r) {
    const int e = t + r * T;
    if (e < COUNT) cp_async4(dst + e, src + e);
  }
}

// Entry e of the upper triangle (i <= c) of an N x N matrix, row by row:
// row i starts at i*N - i*(i-1)/2.
template <int N>
__device__ __forceinline__ void upper_entry(int e, int& i, int& c) {
  i = 0;
#pragma unroll
  for (int j = 1; j < N; ++j) i += e >= j * N - j * (j - 1) / 2;
  c = i + e - (i * N - i * (i - 1) / 2);
}

// Entry e of the lower triangle (c <= r) of an N x N matrix, row by row:
// row r starts at r*(r+1)/2.
template <int N>
__device__ __forceinline__ void lower_entry(int e, int& r, int& c) {
  r = 0;
#pragma unroll
  for (int j = 1; j < N; ++j) r += e >= j * (j + 1) / 2;
  c = e - r * (r + 1) / 2;
}

// Solve Qww x = y for one right-hand column y (in place) by LDL^T, as the
// TPU kernels do: a pivot d <= kPivotTiny (false for NaN too) is replaced by
// d * 0 + 1 and the solve is marked bad. Qww's lower triangle is read from
// shared memory with row stride QS. Every solving thread of a team factors
// Qww itself, in registers: NW <= 8 makes that ~100 FMAs with no barrier,
// where a factorization shared by the team would cost a barrier and a
// shared-memory round trip per pivot. The back substitution multiplies by
// 1/d (DIVIDE false, the structured kernel) or divides by d (DIVIDE true,
// the general one), as each TPU kernel does. Returns 1.f if bad, else 0.f.
template <int NW, bool DIVIDE>
__device__ __forceinline__ float ldl_solve(const float* Qww, int QS, float (&y)[NW]) {
  float L[NW][NW];
  float D[NW];
  float Dinv[NW];
  float bad = 0.f;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    float d = Qww[j * QS + j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k] * D[k];
    const float is_bad = d > kPivotTiny ? 0.f : 1.f;
    bad = fmaxf(bad, is_bad);
    d = d * (1.f - is_bad) + is_bad;
    D[j] = d;
    Dinv[j] = 1.f / d;
#pragma unroll
    for (int i = j + 1; i < NW; ++i) {
      float acc = Qww[i * QS + j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc = acc - L[i][k] * L[j][k] * D[k];
      L[i][j] = acc * Dinv[j];
    }
  }
  // forward substitution L z = y, then L^T x = D^-1 z in place
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    float acc = y[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * y[k];
    y[i] = acc;
  }
#pragma unroll
  for (int i = NW - 1; i >= 0; --i) {
    float acc = DIVIDE ? y[i] / D[i] : y[i] * Dinv[i];
#pragma unroll
    for (int k = i + 1; k < NW; ++k) acc = acc - L[k][i] * y[k];
    y[i] = acc;
  }
  return bad;
}

}  // namespace riccati
