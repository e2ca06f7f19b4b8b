// A stand-in for the parts of the CUDA runtime the Riccati kernels use, so
// that their sources compile with g++ and run on the CPU
// (tests/test_torch_riccati_emulated.py). Each CUDA thread is a host thread;
// the blocks of a launch run one after another; __syncwarp and __syncthreads
// are barriers over the threads of the warp and of the block; a cp.async
// copy is done at once (one order the card may also take). It checks a
// kernel's indexing, team split and barriers, not the card's memory model.
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
inline dim3 blockDim;
typedef void* cudaStream_t;
struct cudaFuncAttributes {
  size_t sharedSizeBytes = 0;
};
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaFuncAttributeMaxDynamicSharedMemorySize };

// the opt-in shared memory a block may have (an H100's by default). Each
// library compiled against this header has its own copy of these (static,
// not inline: an inline variable is one symbol for the whole process).
static int emu_shared_optin = 232448;
static size_t emu_last_dynamic_bytes = 0;
static unsigned emu_last_block = 0, emu_last_grid = 0;
static std::vector<float> emu_dynamic;

inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* value, int, int) {
  *value = emu_shared_optin;
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
