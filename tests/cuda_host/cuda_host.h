// Host stand-in for the subset of CUDA that red_diffeq_tpu_torch/ops/csrc/
// stencil.cu uses, so that g++ can build the source for the CPU tests
// (tests/test_torch_kernel_emulation.py). Every thread of a block runs as a
// fiber (ucontext) on one host thread; __syncthreads() switches to the next
// fiber, so a block runs phase by phase between its barriers as on the card.
// Launches run block after block. The test rewrites `extern __shared__` and
// the `<<<...>>>` launches to the functions below before compiling.
#pragma once
#include <cmath>
#include <cstddef>
#include <functional>
#include <ucontext.h>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 0;
  return cudaSuccess;
}

namespace host {
inline dim3 block_idx, thread_idx, block_dim;
inline std::vector<float> shared;       // the block's dynamic shared memory
inline ucontext_t scheduler;
inline std::vector<ucontext_t> fibers;
inline std::vector<dim3> ids;
inline std::vector<char> done;
inline std::vector<std::vector<char>> stacks;
inline int current = 0;
inline std::function<void()> body;

inline void enter() {
  thread_idx = ids[current];
  body();
  done[current] = 1;
  swapcontext(&fibers[current], &scheduler);
}

// Run every thread of one block, round after round, each up to its next
// barrier, until all have returned.
inline void run_block(dim3 block) {
  const int n = block.x * block.y * block.z;
  fibers.assign(n, ucontext_t());
  ids.resize(n);
  done.assign(n, 0);
  if ((int)stacks.size() < n) stacks.resize(n, std::vector<char>(1 << 16));
  for (int t = 0; t < n; ++t) {
    ids[t] = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
    getcontext(&fibers[t]);
    fibers[t].uc_stack.ss_sp = stacks[t].data();
    fibers[t].uc_stack.ss_size = stacks[t].size();
    fibers[t].uc_link = nullptr;
    makecontext(&fibers[t], enter, 0);
  }
  block_dim = block;
  for (bool running = true; running;) {
    running = false;
    for (int t = 0; t < n; ++t) {
      if (done[t]) continue;
      current = t;
      swapcontext(&scheduler, &fibers[t]);
      running |= !done[t];
    }
  }
}

// kernel<<<grid, block, smem, stream>>>(args...) becomes
// launch(kernel, grid, block, smem, stream)(args...). Shared memory starts
// as NaN, so a read of a cell that nothing wrote shows in the results.
template <class K>
auto launch(K kernel, dim3 grid, dim3 block, size_t smem = 0,
            cudaStream_t = nullptr) {
  return [=](auto... args) {
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          block_idx = dim3(x, y, z);
          shared.assign(smem / sizeof(float) + 4, NAN);
          body = [&]() { kernel(args...); };
          run_block(block);
        }
  };
}
}  // namespace host

#define blockIdx host::block_idx
#define threadIdx host::thread_idx
#define blockDim host::block_dim
inline void __syncthreads() {
  swapcontext(&host::fibers[host::current], &host::scheduler);
  host::thread_idx = host::ids[host::current];
}
