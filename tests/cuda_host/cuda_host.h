// Host stand-in for the subset of CUDA that red_diffeq_tpu_torch/ops/csrc/
// stencil.cu and layout_probe.cu use, so that g++ can build them for the
// CPU tests (tests/test_torch_kernel_emulation.py,
// tests/test_torch_layout_probe.py). Every thread runs as a fiber
// (ucontext) on one host thread. The blocks of one thread-block cluster
// run together as one group of fibers, each block with its own shared
// memory, filled with NaN at the launch so that a read of a cell nothing
// wrote shows in the results. A fiber runs until its next barrier:
// __syncthreads() releases the fibers of its own block once all of them
// have arrived, and the cluster barrier (cooperative_groups::this_cluster()
// .sync(), or its halves barrier_arrive() and barrier_wait()) those of the
// whole cluster once all of its threads have arrived, so a read of a cell
// that another block writes (through map_shared_rank) that no cluster
// barrier orders after the write sees NaN or a stale value. A launch without a cluster dimension runs each
// block as a cluster of one. Clusters run one after another. The test
// rewrites `extern __shared__`, the cooperative_groups include and the
// `<<<...>>>` launches to the functions below before compiling.
//
// The warp-level pieces of layout_probe.cu's tensor-core products, which
// that source reaches behind `#ifdef CUDA_HOST_EMULATION` (defined here):
// __syncwarp() releases the live threads of its warp (32 consecutive
// threads of the block); mma_m16n8k8_tf32 is mma.sync.aligned.m16n8k8
// .row.col.f32.tf32.tf32.f32 on the PTX ISA's register fragments, each
// lane handing in its own and the warp exchanging them at warp barriers;
// cp_async queues a copy that the thread's cp_async_wait carries out, so a
// read of a stage before its wait (and the __syncthreads after it) sees
// NaN or old data.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <functional>
#include <sys/mman.h>
#include <ucontext.h>
#include <vector>

#define CUDA_HOST_EMULATION 1

#define __global__
#define __host__
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
inline float2 make_float2(float x, float y) { return float2{x, y}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
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
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t*) {
  *n = 0;
  return cudaSuccess;
}

inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}

namespace host {
constexpr int kWarp = 32;
struct Warp {
  int arrived = 0, live = 0;   // at its barrier; threads not yet returned
  unsigned gen = 0;            // barrier releases so far
  unsigned a[kWarp][4], b[kWarp][2];   // the lanes' mma fragments
};
struct Block {
  dim3 idx;
  std::vector<float> shared;   // the block's dynamic shared memory
  int arrived = 0, live = 0;   // at its barrier; threads not yet returned
  unsigned gen = 0;            // barrier releases so far
  std::vector<Warp> warps;
};
struct Copy {                  // one cp.async, carried out at its wait
  void* dst;
  const void* src;
  int bytes, src_bytes;
};
struct Fiber {
  ucontext_t ctx;
  dim3 tid;
  int block = 0;               // its block's rank in the cluster
  int warp = 0, lane = 0;      // in its block
  int wait = 0;                // 0 running, 1 block barrier, 2 cluster's,
                               // 3 warp's
  unsigned bgen = 0, cgen = 0;  // releases of the block's and cluster's
                                // barriers when it last arrived at each
  unsigned wgen = 0;            // and of its warp's
  bool done = false;
  std::vector<Copy> open;                // cp.async since the last commit
  std::vector<std::vector<Copy>> groups;  // committed, not yet waited for
};
constexpr size_t kStack = 1 << 16;
inline dim3 block_idx, thread_idx;
inline std::vector<Block> blocks;    // the running cluster's, by rank
inline std::vector<Fiber> fibers;
inline std::vector<char*> stacks;    // reserved, touched only as used
inline int cl_arrived = 0, cl_live = 0;
inline unsigned cl_gen = 0;
inline ucontext_t scheduler;
inline int current = 0;
inline std::function<void()> body;

inline void resume_state() {
  const Fiber& f = fibers[current];
  thread_idx = f.tid;
  block_idx = blocks[f.block].idx;
}

inline void enter() {
  resume_state();
  body();
  Fiber& f = fibers[current];
  f.done = true;
  Block& b = blocks[f.block];
  // A returned thread no longer holds back its block's, warp's or
  // cluster's barrier.
  if (--b.live > 0 && b.arrived == b.live) { b.arrived = 0; ++b.gen; }
  Warp& w = b.warps[f.warp];
  if (--w.live > 0 && w.arrived == w.live) { w.arrived = 0; ++w.gen; }
  if (--cl_live > 0 && cl_arrived == cl_live) { cl_arrived = 0; ++cl_gen; }
  swapcontext(&f.ctx, &scheduler);
}

inline float* shared_mem() { return blocks[fibers[current].block].shared.data(); }

// Whether the barrier fiber f waits at (f.wait 1: its block's, 2: the
// cluster's, 3: its warp's) has been released since it arrived.
inline bool released(const Fiber& f, int wait) {
  if (wait == 1) return blocks[f.block].gen != f.bgen;
  if (wait == 2) return cl_gen != f.cgen;
  return blocks[f.block].warps[f.warp].gen != f.wgen;
}

// Yield to the scheduler until the barrier this fiber waits at has been
// released since it arrived.
inline void block_until_released(int wait) {
  Fiber& f = fibers[current];
  if (released(f, wait)) return;
  f.wait = wait;
  swapcontext(&f.ctx, &scheduler);
  resume_state();
}

// __syncthreads(): arrive at the block barrier, return once released.
inline void block_barrier() {
  Fiber& f = fibers[current];
  Block& b = blocks[f.block];
  f.bgen = b.gen;
  if (++b.arrived == b.live) { b.arrived = 0; ++b.gen; }
  block_until_released(1);
}

// The cluster barrier's two halves: arrive, and wait until every thread of
// the cluster has arrived. An arriving thread yields, so that the threads
// of its block that arrive after it run on first.
inline void cluster_arrive() {
  Fiber& f = fibers[current];
  f.cgen = cl_gen;
  if (++cl_arrived == cl_live) { cl_arrived = 0; ++cl_gen; }
  f.wait = 0;
  swapcontext(&f.ctx, &scheduler);
  resume_state();
}

inline void cluster_wait() { block_until_released(2); }

// __syncwarp(): arrive at the warp's barrier, return once released.
inline void warp_barrier() {
  Fiber& f = fibers[current];
  Warp& w = blocks[f.block].warps[f.warp];
  f.wgen = w.gen;
  if (++w.arrived == w.live) { w.arrived = 0; ++w.gen; }
  block_until_released(3);
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 d, a, b, c with d
// written over c, for the calling lane. The PTX ISA's fragments, with
// g = lane >> 2 and t = lane % 4: a0..a3 hold A at (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b0, b1 hold B at (t, g), (t + 4, g); c0..c3
// hold C and D at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). The
// tensor cores read a TF32 operand's top 19 bits. Each element of D is its
// C plus the 8 products A[m][k] * B[k][n] added k = 0 .. 7 in order, one
// fp32 rounding an add (a product of two TF32 values is exact in fp32);
// the card's own order and rounding of that sum differ.
inline void mma_m16n8k8_tf32(float (&c)[4], const unsigned (&a)[4],
                             const unsigned (&b)[2]) {
  const int lane = fibers[current].lane;
  Warp& w = blocks[fibers[current].block].warps[fibers[current].warp];
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) w.b[lane][i] = b[i];
  warp_barrier();
  const int g = lane >> 2, t = lane & 3;
  float d[4];
  for (int i = 0; i < 4; ++i) {
    const int m = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    float acc = c[i];
    for (int k = 0; k < 8; ++k) {
      const float x = __uint_as_float(
          w.a[(m % 8) * 4 + k % 4][m / 8 + 2 * (k / 4)] & ~0x1fffu);
      const float y = __uint_as_float(w.b[n * 4 + k % 4][k / 4] & ~0x1fffu);
      acc = acc + x * y;
    }
    d[i] = acc;
  }
  warp_barrier();   // every lane has read the fragments before any rewrites
  for (int i = 0; i < 4; ++i) c[i] = d[i];
}

// cp.async of `bytes` bytes from src to dst (shared memory): `src_bytes`
// of them read, the rest zero-filled, when the thread's cp_async_wait
// retires its group.
inline void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  fibers[current].open.push_back(Copy{dst, src, bytes, src_bytes});
}

// cp.async.commit_group: the copies since the last commit become a group.
inline void cp_async_commit() {
  Fiber& f = fibers[current];
  f.groups.push_back(std::move(f.open));
  f.open.clear();
}

// cp.async.wait_group n: every group but the newest n is done.
inline void cp_async_wait(int n) {
  Fiber& f = fibers[current];
  const int done = (int)f.groups.size() - n;
  if (done <= 0) return;
  for (int i = 0; i < done; ++i)
    for (const Copy& c : f.groups[i]) {
      std::memcpy(c.dst, c.src, c.src_bytes);
      std::memset(static_cast<char*>(c.dst) + c.src_bytes, 0,
                  c.bytes - c.src_bytes);
    }
  f.groups.erase(f.groups.begin(), f.groups.begin() + done);
}

// Run every thread of the cluster's blocks (block_ids, in rank order)
// until all have returned: round after round, the lowest-ranked block with
// a thread free to run runs each such thread up to its next barrier (or
// cluster arrive). Block 0 thus runs as far ahead of the others as its
// barriers allow, so that a read its barriers do not order after another
// block's write sees the old value. Aborts if every thread left waits at a
// barrier that can no longer be released.
inline void run_cluster(const std::vector<dim3>& block_ids, dim3 block,
                        size_t smem) {
  const int per = block.x * block.y * block.z;
  const int nb = (int)block_ids.size(), n = nb * per;
  blocks.assign(nb, Block());
  for (int i = 0; i < nb; ++i) {
    blocks[i].idx = block_ids[i];
    blocks[i].shared.assign(smem / sizeof(float) + 4, NAN);
    blocks[i].live = per;
    blocks[i].warps.assign((per + kWarp - 1) / kWarp, Warp());
    for (int w = 0; w < (int)blocks[i].warps.size(); ++w)
      blocks[i].warps[w].live = std::min(kWarp, per - w * kWarp);
  }
  cl_arrived = 0;
  cl_live = n;
  cl_gen = 0;
  fibers.assign(n, Fiber());
  while ((int)stacks.size() < n) {
    void* p = mmap(nullptr, kStack, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) { std::perror("mmap"); std::abort(); }
    stacks.push_back(static_cast<char*>(p));
  }
  for (int t = 0; t < n; ++t) {
    const int i = t % per;
    fibers[t].block = t / per;
    fibers[t].warp = i / kWarp;
    fibers[t].lane = i % kWarp;
    fibers[t].tid = dim3(i % block.x, (i / block.x) % block.y,
                         i / (block.x * block.y));
    getcontext(&fibers[t].ctx);
    fibers[t].ctx.uc_stack.ss_sp = stacks[t];
    fibers[t].ctx.uc_stack.ss_size = kStack;
    fibers[t].ctx.uc_link = nullptr;
    makecontext(&fibers[t].ctx, enter, 0);
  }
  for (int left = n; left > 0;) {
    bool moved = false;
    for (int t = 0; t < n; ++t) {
      if (moved && t % per == 0) break;    // one block a round
      Fiber& f = fibers[t];
      if (f.done) continue;
      if (f.wait && !released(f, f.wait)) continue;
      f.wait = 0;
      current = t;
      swapcontext(&scheduler, &f.ctx);
      moved = true;
      if (fibers[t].done) --left;
    }
    if (!moved) {
      std::fprintf(stderr, "cuda_host: every thread left waits at a barrier "
                           "that cannot be released\n");
      std::abort();
    }
  }
}

// kernel<<<grid, block, smem, stream>>>(args...) becomes
// launch(kernel, grid, block, smem, stream)(args...): each block a cluster
// of one.
template <class K>
auto launch(K kernel, dim3 grid, dim3 block, size_t smem = 0,
            cudaStream_t = nullptr) {
  return [=](auto... args) {
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          body = [&]() { kernel(args...); };
          run_cluster({dim3(x, y, z)}, block, smem);
        }
  };
}
}  // namespace host

// A launch with a cluster dimension among its attributes: the grid's
// clusters, each run as one group of fibers.
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(P...),
                               A&&... args) {
  dim3 cd(1, 1, 1);
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      const auto& v = c->attrs[i].val.clusterDim;
      cd = dim3(v.x, v.y, v.z);
    }
  const dim3 g = c->gridDim;
  if (g.x % cd.x || g.y % cd.y || g.z % cd.z) return cudaErrorInvalidValue;
  host::body = [&]() { k(static_cast<P>(args)...); };
  for (unsigned cz = 0; cz < g.z; cz += cd.z)
    for (unsigned cy = 0; cy < g.y; cy += cd.y)
      for (unsigned cx = 0; cx < g.x; cx += cd.x) {
        std::vector<dim3> ids;   // rank order: x fastest
        for (unsigned z = 0; z < cd.z; ++z)
          for (unsigned y = 0; y < cd.y; ++y)
            for (unsigned x = 0; x < cd.x; ++x)
              ids.push_back(dim3(cx + x, cy + y, cz + z));
        host::run_cluster(ids, c->blockDim, c->dynamicSmemBytes);
      }
  return cudaSuccess;
}

#define blockIdx host::block_idx
#define threadIdx host::thread_idx
inline void __syncthreads() { host::block_barrier(); }
inline void __syncwarp(unsigned = 0xffffffffu) { host::warp_barrier(); }

// The cluster calls of cooperative_groups that stencil.cu makes.
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return (unsigned)host::fibers[host::current].block; }
  void sync() const {
    host::cluster_arrive();
    host::cluster_wait();
  }
  void barrier_arrive() const { host::cluster_arrive(); }
  void barrier_wait() const { host::cluster_wait(); }
  template <class T>
  T* map_shared_rank(T* p, int rank) const {
    const std::ptrdiff_t o = reinterpret_cast<char*>(p) -
                             reinterpret_cast<char*>(host::shared_mem());
    return reinterpret_cast<T*>(
        reinterpret_cast<char*>(host::blocks[rank].shared.data()) + o);
  }
};
inline cluster_group this_cluster() { return cluster_group(); }
}  // namespace cooperative_groups
