// Device helpers shared by the two Riccati sweep kernels (riccati_packed.cu,
// riccati_batched.cu) and the split expansion's kernels (fk_walk.cu,
// gn_assemble.cu): the thread-team geometry, 4-byte cp.async staging of a
// lane's stage block, block-wide stores of a tile, the card's size, index
// maps that spread a triangle over a team, and the LDL^T stage solve of one
// right-hand column.
#pragma once

#include <cuda_runtime.h>

namespace riccati {

constexpr float kPivotTiny = 1e-12f;
// threads per block at most; a block holds up to kBlockThreads / T lanes of
// T threads each, fewer where their shared memory does not fit (lanes_per_block)
constexpr int kBlockThreads = 128;
// what a launcher returns besides a cudaError_t (ops/_build.py reads them):
// called with a shape other than the one its library was compiled for, or a
// shape of which not one lane's shared memory fits a block
constexpr int kNoInstantiation = -1;
constexpr int kNoRoom = -2;

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

// The shared memory a block of `kernel` may have, in bytes: the card's
// opt-in maximum (227 KB on an H100), all of which `kernel` is allowed to
// take as dynamic shared memory. Call once per kernel (a static).
template <class Kernel>
int dynamic_shared_limit(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return optin;
}

// Lanes per block: kBlockThreads / T, or as many as `limit` bytes of shared
// memory hold beside `fixed` bytes, if fewer; 0 if not one lane fits.
inline int lanes_per_block(int T, size_t lane_bytes, size_t fixed, int limit) {
  if (fixed + lane_bytes > static_cast<size_t>(limit)) return 0;
  const size_t fit = (static_cast<size_t>(limit) - fixed) / lane_bytes;
  return fit < static_cast<size_t>(kBlockThreads / T) ? static_cast<int>(fit) : kBlockThreads / T;
}

// The card's streaming multiprocessors (132 on an H100 SXM).
inline int multiprocessor_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks of `kernel` that one SM holds at once with `threads` threads and
// `bytes` of dynamic shared memory each (at least 1).
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, size_t bytes) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  return blocks > 0 ? blocks : 1;
}

// The block's `threads` threads write `count` floats of a tile in shared
// memory to a contiguous run in device memory, consecutive threads on
// consecutive addresses: as 16-byte vectors where both ends are 16-byte
// aligned (then a scalar tail of count % 4), else float by float.
__device__ __forceinline__ void block_store(float* __restrict__ dst, const float* __restrict__ src, int count,
                                            int t, int threads) {
  int done = 0;
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) == 0) {
    const int vectors = count / 4;
#pragma unroll 4
    for (int v = t; v < vectors; v += threads)
      reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(src)[v];
    done = 4 * vectors;
  }
  for (int e = done + t; e < count; e += threads) dst[e] = src[e];
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
// Qww itself, in registers: at NW <= 9 that is ~100-250 FMAs with no
// barrier, where a factorization shared by the team would cost a barrier
// and a shared-memory round trip per pivot. (A thread with several
// columns, where 1 + NX passes the team, factors once per column.) The back substitution multiplies by
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
