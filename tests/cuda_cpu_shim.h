// A stand-in for the parts of the CUDA runtime the port's kernels use, so
// that their sources compile with g++ and run on the CPU
// (tests/test_torch_riccati_emulated.py, tests/test_torch_fk_gn_emulated.py).
// Each CUDA thread is a host thread; the blocks of a launch run one after
// another; __syncwarp and __syncthreads are barriers over the threads of the
// warp and of the block; a cp.async copy is done at once (one order the card
// may also take); float4 / int4 are 16-byte aligned structs, so a vector
// load or store is a copy of four words. The card is an H100 unless a test
// says otherwise: its opt-in shared memory, 132 SMs, and as many resident
// blocks an SM as 2,048 threads and 228 KB of shared memory (1 KB of it
// reserved per block) hold. It checks a kernel's indexing, team split and
// barriers, not the card's memory model.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
struct cudaFuncAttributes {
  size_t sharedSizeBytes = 0;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaFuncAttributeMaxDynamicSharedMemorySize,
       cudaDevAttrMultiProcessorCount };

// the opt-in shared memory a block may have (an H100's by default). Each
// library compiled against this header has its own copy of these (static,
// not inline: an inline variable is one symbol for the whole process).
static int emu_shared_optin = 232448;
static int emu_sm_count = 132;
constexpr size_t emu_shared_per_sm = 233472, emu_reserved_per_block = 1024;
static size_t emu_last_dynamic_bytes = 0;
static unsigned emu_last_block = 0, emu_last_grid = 0;
static std::vector<float> emu_dynamic;

inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* value, int attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? emu_sm_count : emu_shared_optin;
  return 0;
}
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int threads, size_t dynamic_bytes) {
  const int by_threads = 2048 / threads;
  const int by_shared = static_cast<int>(emu_shared_per_sm / (dynamic_bytes + emu_reserved_per_block));
  *blocks = by_threads < by_shared ? by_threads : by_shared;
  return 0;
}
template <class F>
int cudaFuncGetAttributes(cudaFuncAttributes* attr, F) {
  attr->sharedSizeBytes = 0;
  return 0;
}
template <class F>
int cudaFuncSetAttribute(F, int, int) {
  return 0;
}

inline thread_local std::barrier<>* emu_warp;
inline thread_local std::barrier<>* emu_block;
inline void __syncwarp() { emu_warp->arrive_and_wait(); }
inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline float* emu_dynamic_shared() { return emu_dynamic.data(); }

// kernel<<<grid, block, dynamic_bytes, stream>>>(...) as
// emu_launch(grid, block, dynamic_bytes, stream, [&] { kernel(...); })
template <class F>
void emu_launch(int grid, int block, size_t dynamic_bytes, cudaStream_t, F call) {
  blockDim.x = block;
  gridDim.x = grid;
  emu_last_dynamic_bytes = dynamic_bytes;
  emu_last_block = block;
  emu_last_grid = grid;
  for (int bx = 0; bx < grid; ++bx) {
    emu_dynamic.assign(dynamic_bytes / sizeof(float) + 1, NAN);
    std::barrier<> block_barrier(block);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    // a block of fewer than 32 threads, or a part-filled last warp, is a
    // warp of those threads only
    for (int w = 0; w < (block + 31) / 32; ++w)
      warps.emplace_back(new std::barrier<>(block - 32 * w < 32 ? block - 32 * w : 32));
    std::vector<std::thread> threads;
    for (int tx = 0; tx < block; ++tx)
      threads.emplace_back([&, tx] {
        threadIdx.x = tx;
        blockIdx.x = bx;
        emu_warp = warps[tx / 32].get();
        emu_block = &block_barrier;
        call();
      });
    for (auto& th : threads) th.join();
  }
}

extern "C" size_t emu_dynamic_bytes() { return emu_last_dynamic_bytes; }
extern "C" unsigned emu_block_threads() { return emu_last_block; }
extern "C" unsigned emu_grid_blocks() { return emu_last_grid; }
extern "C" void emu_set_shared_optin(int bytes) { emu_shared_optin = bytes; }
extern "C" void emu_set_sm_count(int sms) { emu_sm_count = sms; }
