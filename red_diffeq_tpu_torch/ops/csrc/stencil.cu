// Acoustic FD time stepper for Hopper (sm_90a): the forward, the tape-free
// adjoint and its shot sum, and the taped pair (tape replay, taped adjoint
// step), with a plain C interface loaded through ctypes
// (red_diffeq_tpu_torch/ops/stencil.py).
//
// fwd_step replaces _fwd_kernel (red_diffeq_tpu/ops/stencil.py:150-231,
// launched by _run_fwd at :510). bwd_reverse_step replaces
// _bwd_reverse_kernel (:352-443, launched by _run_bwd_reverse at :632).
// tape_step replaces _tape_kernel (:233-268, launched by _run_tape at :550),
// and so do tape_step_stream for fields too large for tape_step's thread-
// block cluster and tape_step_global for fields too large for
// tape_step_stream's; bwd_tape_step replaces _bwd_kernel (:271-349,
// launched by _run_bwd at :582); the JAX package takes that pair when its
// t2 guard trips. sum_shots
// does both adjoints' cross-shot sum of the coefficient cotangents (the
// shot-shared coefficient blocks the JAX kernels add into, :341-343 and
// :435-437).
//
// Recursion, per (sample b, shot s) field of Hp x Wp cells:
//   s_m = t1*s_{m-1} - t2*s_{m-2} + alpha*L(s_{m-1}),  then row isz += inj*src[k]
// with L the circular 4th-order Laplacian (C2 = 4/3, C3 = -1/12).
//
// Bound on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32). Per cell and
// step the forward and the tape replay do 14 fp32 operations, the tape-free
// adjoint 35 and the taped adjoint 30. Counting each chunk call's inputs and
// outputs once, one 1000-step pass at the headline (B=4, ns=5, 310x310,
// chunk 20) is bound by bytes for the forward (0.53 ms), the tape replay
// (2.7 ms: it writes chunk + 1 fields a chunk) and both adjoints' steps
// (which write per-shot sums), by operations for the tape-free adjoint's
// whole chunk; chip_smoke.py computes them all.
//
// fwd_step, bwd_reverse_step and bwd_tape_step are temporally blocked: one
// launch takes U steps (U = 4 at the headline, rdt_blocking below) of one
// tile of one (sample, shot) field. A 310x310 fp32 field is 384 KB, above
// the 227 KB of shared memory a block may have, so the TPU's
// whole-field-resident program becomes tiles with a halo of 2U cells (see
// "Temporal blocking" below). Their cost is the window's traffic through L2
// each launch (a 64x64 window for a 48x48 forward tile, 32x64 for a 16x48
// adjoint tile) and the steps' shared-memory and fp32 work on the shrinking
// halo, not the launch rate: one launch per U steps, state in registers and
// shared memory between the steps. The adjoints give each (b, s, cell) to
// one thread and keep this shot's alpha/t1/t2 cotangents in per-shot
// running sums (B, ns, Hp, Wp); sum_shots adds them over shots in shot
// order once per chunk, launched by the chunk's launcher after its last
// group. No floating-point atomics anywhere: every sum has one fixed
// order, so results repeat bit for bit. Build with -fmad=false: every
// multiply and add rounds as in the plain PyTorch version (same grouping
// as ops/stencil.py), which the rebuild's divide by t2 (error growth up to
// (1/t2)^chunk) needs; halo cells repeat their owner's operations, so the
// blocked kernels equal their plain versions bit for bit.
//
// The taped pair does not keep the TPU's haloed tape blocks (U+2 states
// per grid iteration, so that one VMEM block serves one iteration): its
// tape is flat, chunk+1 states of (B, ns, Hp, Wp) with slot i = s_{i-1}, so
// slots 0 and 1 are the chunk-start carry and slot chunk is s_{chunk-1};
// the chunk-end state, which the sweep never reads, is not replayed.
// tape_step replays a whole chunk in one launch, the TPU kernel's
// whole-field residency kept by a thread-block cluster: one (sample, shot)
// field a cluster of up to 16 blocks on neighbouring SMs, each a strip of
// rows in shared memory, halo rows exchanged through distributed shared
// memory (see "The tape replay" below); tape_step_stream does the same
// with some of the coefficient planes read from device memory, where all
// three do not fit beside the states. bwd_tape_step reads s_{m-1} and
// s_{m-2} from slots m and m-1 where bwd_reverse_step rebuilds s_{m-2},
// and never divides by t2; it reads the tape only at its tile and 2 cells
// around it, each slot once a launch. The tape lives only during one
// chunk's backward, as in the JAX custom VJP; at the headline it is above
// the L2, so the taped pair streams from HBM.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace {

constexpr float kC2 = (float)(4.0 / 3.0);
constexpr float kC3 = (float)(-1.0 / 12.0);

// Every kernel takes the circular Laplacian L in the grouping of
// red_diffeq_tpu/solvers/acoustic.py:188-191 (roll(p, 1)[y] = p[y - 1]):
//   kC2*(((p[y-1] + p[y+1]) + p[x-1]) + p[x+1])
//     + kC3*(((p[y-2] + p[y+2]) + p[x-2]) + p[x+2]).

// ---------------------------------------------------------------------------
// Temporal blocking. A block owns a tile of one (sample, shot) field and
// loads a window of the tile plus a halo of h = 2U cells on each side
// (indices wrap: the Laplacian is circular). It takes n <= U steps there,
// and writes the tile once. After step s the cells within 2s of the window's
// edge hold garbage (their stencil reached outside the window); the tile
// lies 2U cells inside, so its cells are right after U steps. Cells repeat
// their owner's arithmetic operation for operation, so every cell comes out
// bit for bit as with one step per launch; only the tile's own cells record
// receivers or add to sums.
//
// Each thread keeps an MY x MX micro-tile of cells of the window in
// registers and exchanges its edges with its neighbours through two shared
// windows used in turn (read one, write the other, one barrier a step).
// Rows are read as float4 (MX = 4), edge columns as float2.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// A window of LY x LX cells in shared memory, with 2 pad rows above and
// below and 4 pad columns left and right (so rows stay 16-byte aligned);
// the pads are zero and only ever read for cells that turn to garbage.
template <int MX_, int MY_, int NTX_, int NTY_>
struct Layout {
  static constexpr int MX = MX_, MY = MY_, NTX = NTX_, NTY = NTY_;
  static constexpr int LX = MX * NTX, LY = MY * NTY, THREADS = NTX * NTY;
  static constexpr int SX = LX + 8;
  static constexpr int SIZE = (LY + 4) * SX;
  __device__ static int at(int y, int x) { return (y + 2) * SX + x + 4; }
};

template <int M>
__device__ __forceinline__ void load_row(const float* p, float (&o)[M]) {
  static_assert(M == 4, "rows are read as float4");
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

template <int M>
__device__ __forceinline__ void store_row(float* p, const float (&v)[M]) {
  static_assert(M == 4, "rows are written as float4");
  float4 t;
  t.x = v[0]; t.y = v[1]; t.z = v[2]; t.w = v[3];
  *reinterpret_cast<float4*>(p) = t;
}

__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a = t.x;
  b = t.y;
}

// The four rows above and below a thread's micro-tile in a window.
template <class L>
struct Edges {
  float up2[L::MX], up1[L::MX], dn1[L::MX], dn2[L::MX];
  __device__ Edges(const float* win, int ly, int lx) {
    load_row(&win[L::at(ly - 2, lx)], up2);
    load_row(&win[L::at(ly - 1, lx)], up1);
    load_row(&win[L::at(ly + L::MY, lx)], dn1);
    load_row(&win[L::at(ly + L::MY + 1, lx)], dn2);
  }
};

// L(f) at cell (j, i) of a micro-tile f, whose field values are f itself
// at its own cells, the edge rows e above and below, and l2, l1 | r1, r2
// left and right of row j. In the grouping of L; j and i are constants
// after unrolling, so every neighbour is a register.
template <class L>
__device__ __forceinline__ float lap_cell(const float (&f)[L::MY][L::MX],
                                          const Edges<L>& e, float l2,
                                          float l1, float r1, float r2,
                                          int j, int i) {
  constexpr int MX = L::MX, MY = L::MY;
  const float ym2 = j >= 2 ? f[j - 2][i] : (j == 1 ? e.up1[i] : e.up2[i]);
  const float ym1 = j >= 1 ? f[j - 1][i] : e.up1[i];
  const float yp1 = j + 1 < MY ? f[j + 1][i] : e.dn1[i];
  const float yp2 = j + 2 < MY ? f[j + 2][i]
                               : (j + 2 == MY ? e.dn1[i] : e.dn2[i]);
  const float xm2 = i >= 2 ? f[j][i - 2] : (i == 1 ? l1 : l2);
  const float xm1 = i >= 1 ? f[j][i - 1] : l1;
  const float xp1 = i + 1 < MX ? f[j][i + 1] : r1;
  const float xp2 = i + 2 < MX ? f[j][i + 2] : (i + 2 == MX ? r1 : r2);
  return kC2 * (((ym1 + yp1) + xm1) + xp1) +
         kC3 * (((ym2 + yp2) + xm2) + xp2);
}

// A thread's micro-tile: the tile's and the micro-tile's origins, and bit
// masks over the micro-tile's rows (bit j) and columns (bit i): the tile's
// own rows and columns, the source row, the receiver row and the receiver
// line's columns. Column indices come from the window's gxv on demand.
template <class L>
struct Cells {
  int ly, lx, h, ty, tx, y0, x0;
  unsigned own_y = 0, own_x = 0, src_y = 0, rec_y = 0, rec_x = 0;
  const int* gxv = nullptr;
  __device__ explicit Cells(int unroll) {
    h = 2 * unroll;
    ty = L::LY - 2 * h;
    tx = L::LX - 2 * h;
    y0 = blockIdx.y * ty;
    x0 = blockIdx.x * tx;
    ly = threadIdx.y * L::MY;
    lx = threadIdx.x * L::MX;
  }
  // The masks, once the window's rows gyv and columns gxv are in place.
  __device__ void classify(const int* gyv, const int* gxv_, int H, int W,
                           int isz, int igz, int g0, int ng) {
    gxv = gxv_;
#pragma unroll
    for (int j = 0; j < L::MY; ++j) {
      const int t = ly + j - h, gy = gyv[ly + j];
      own_y |= (unsigned)(t >= 0 && t < ty && y0 + t < H) << j;
      src_y |= (unsigned)(gy == isz) << j;
      rec_y |= (unsigned)(gy == igz) << j;
    }
#pragma unroll
    for (int i = 0; i < L::MX; ++i) {
      const int t = lx + i - h, gx = gxv[lx + i];
      own_x |= (unsigned)(t >= 0 && t < tx && x0 + t < W) << i;
      rec_x |= (unsigned)(gx >= g0 && gx < g0 + ng) << i;
    }
  }
  __device__ bool oy(int j) const { return own_y >> j & 1u; }
  __device__ bool ox(int i) const { return own_x >> i & 1u; }
  __device__ bool src(int j) const { return src_y >> j & 1u; }
  __device__ bool rec(int j, int i) const {
    return (rec_y >> j & 1u) && (rec_x >> i & 1u);
  }
  __device__ int gx(int i) const { return gxv[lx + i]; }
  // Whether any cell of the micro-tile lies r or more cells inside the
  // window (the region still right after step r/2).
  __device__ bool live(int r) const {
    return ly + L::MY > r && ly < L::LY - r && lx + L::MX > r &&
           lx < L::LX - r;
  }
};

// Zero the pad cells of the first n windows (never copied into; read only
// for cells that turn to garbage): 2 rows above and below, 4 columns left
// and right of each.
template <class L>
__device__ __forceinline__ void zero_pads(float* smem, int n) {
  constexpr int ROWS = 4 * L::SX, PER = ROWS + 8 * L::LY;
  const int tid = threadIdx.y * L::NTX + threadIdx.x;
  for (int i = tid; i < n * PER; i += L::THREADS) {
    const int w = i / PER, k = i % PER;
    int y, x;
    if (k < ROWS) {
      y = k / L::SX;
      y = y < 2 ? y - 2 : L::LY + y - 2;
      x = k % L::SX - 4;
    } else {
      y = (k - ROWS) / 8;
      x = (k - ROWS) % 8;
      x = x < 4 ? x - 4 : L::LX + x - 4;
    }
    smem[w * L::SIZE + L::at(y, x)] = 0.0f;
  }
}

// One float from device to shared memory, asynchronously (cp.async); the
// copies of a thread are complete after copy_wait(), those of the block
// after a barrier that follows it.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// The global row of each window row and the global column of each window
// column, into gyv[LY] and gxv[LX].
template <class L>
__device__ __forceinline__ void window_index(int* gyv, int* gxv, int y0h,
                                             int x0h, int H, int W) {
  const int tid = threadIdx.y * L::NTX + threadIdx.x;
  for (int i = tid; i < L::LY; i += L::THREADS) gyv[i] = wrap(y0h + i, H);
  for (int i = tid; i < L::LX; i += L::THREADS) gxv[i] = wrap(x0h + i, W);
}

// Whether window cell (y, x) is one of the tile's own cells in the field.
template <class L>
__device__ __forceinline__ bool tile_cell(const Cells<L>& m, int y, int x,
                                          int H, int W) {
  const int ty = y - m.h, tx = x - m.h;
  return ty >= 0 && ty < m.ty && tx >= 0 && tx < m.tx && m.y0 + ty < H &&
         m.x0 + tx < W;
}

// The forward's blocking: 4x4 cells a thread, 16x16 threads, a 64x64
// window (48x48 tile at U=4); two state windows, the alpha, t1, t2
// windows and the window's rows and columns in shared memory (98 KB).
using FwdL = Layout<4, 4, 16, 16>;

// Steps k0 .. k0+n-1 (n <= unroll) of the forward, one block per (tile,
// sample*shot). in0, in1 hold s_{k0-2}, s_{k0-1}; out0, out1 receive
// s_{k0+n-2}, s_{k0+n-1}. A thread keeps s_{m-1} (p) and s_{m-2} (q) of its
// cells in registers, s_{m-1} also in the shared window its neighbours
// read; s_m is computed into q (which only its own cell reads), then p and
// q swap names.
__global__ void __launch_bounds__(FwdL::THREADS, 2) fwd_step(
    const float* __restrict__ in0, const float* __restrict__ in1,
    float* __restrict__ out0, float* __restrict__ out1,
    const float* __restrict__ alpha, const float* __restrict__ t1,
    const float* __restrict__ t2, const float* __restrict__ inj,
    const float* __restrict__ src, float* __restrict__ recs, int k0, int n,
    int unroll, int ns, int H, int W, int isz, int igz, int g0, int ng,
    int chunk) {
  using L = FwdL;
  constexpr int MX = L::MX, MY = L::MY;
  extern __shared__ float smem[];
  // Window offsets in smem: the state pair in turn, then alpha, t1, t2.
  int cur = 0, nxt = L::SIZE;
  constexpr int WA = 2 * L::SIZE, W1 = 3 * L::SIZE, W2 = 4 * L::SIZE;
  Cells<L> m(unroll);
  const int bs = blockIdx.z;
  const size_t f = (size_t)bs * H * W;
  const size_t cb = (size_t)(bs / ns) * H * W;
  const float* injr = inj + (size_t)bs * W;
  // The window, in coalesced order: s_{m-1} into the current state window,
  // s_{m-2} into the other one (each thread then reads its own cells),
  // alpha, t1, t2.
  int* gyv = reinterpret_cast<int*>(smem + 5 * L::SIZE);
  int* gxv = gyv + L::LY;
  window_index<L>(gyv, gxv, m.y0 - m.h, m.x0 - m.h, H, W);
  zero_pads<L>(smem, 2);
  __syncthreads();
  m.classify(gyv, gxv, H, W, isz, igz, g0, ng);
  const int tid = threadIdx.y * L::NTX + threadIdx.x;
  for (int i = tid; i < L::LY * L::LX; i += L::THREADS) {
    const int y = i / L::LX, x = i % L::LX, c = L::at(y, x);
    const size_t g = (size_t)gyv[y] * W + gxv[x];
    copy_async(&smem[cur + c], in1 + f + g);
    copy_async(&smem[nxt + c], in0 + f + g);
    copy_async(&smem[WA + c], alpha + cb + g);
    copy_async(&smem[W1 + c], t1 + cb + g);
    copy_async(&smem[W2 + c], t2 + cb + g);
  }
  copy_wait();
  __syncthreads();
  float p[MY][MX], q[MY][MX];
#pragma unroll
  for (int j = 0; j < MY; ++j) {
    load_row(&smem[cur + L::at(m.ly + j, m.lx)], p[j]);
    load_row(&smem[nxt + L::at(m.ly + j, m.lx)], q[j]);
  }
  for (int s = 0; s < n; ++s) {
    const int k = k0 + s;
    if (m.live(2 * (unroll - n + 1 + s))) {
      const float sk = src[k];
      const Edges<L> e(&smem[cur], m.ly, m.lx);
#pragma unroll
      for (int j = 0; j < MY; ++j) {
        float l2, l1, r1, r2, a[MX], c1[MX], c2[MX];
        load_pair(&smem[cur + L::at(m.ly + j, m.lx - 2)], l2, l1);
        load_pair(&smem[cur + L::at(m.ly + j, m.lx + MX)], r1, r2);
        load_row(&smem[WA + L::at(m.ly + j, m.lx)], a);
        load_row(&smem[W1 + L::at(m.ly + j, m.lx)], c1);
        load_row(&smem[W2 + L::at(m.ly + j, m.lx)], c2);
#pragma unroll
        for (int i = 0; i < MX; ++i) {
          float v = (c1[i] * p[j][i] - c2[i] * q[j][i]) +
                    a[i] * lap_cell<L>(p, e, l2, l1, r1, r2, j, i);
          if (m.src(j)) v = v + injr[m.gx(i)] * sk;
          q[j][i] = v;
          if (m.oy(j) && m.ox(i) && m.rec(j, i))
            recs[((size_t)bs * chunk + k) * ng + (m.gx(i) - g0)] = v;
        }
      }
#pragma unroll
      for (int j = 0; j < MY; ++j) {
#pragma unroll
        for (int i = 0; i < MX; ++i) {
          const float t = p[j][i];
          p[j][i] = q[j][i];
          q[j][i] = t;
        }
        store_row(&smem[nxt + L::at(m.ly + j, m.lx)], p[j]);
      }
    }
    __syncthreads();
    const int t = cur; cur = nxt; nxt = t;
  }
  // The current window holds s_{m-1} at every live cell; s_{m-2} goes to
  // the other, then the tile leaves in coalesced order.
#pragma unroll
  for (int j = 0; j < MY; ++j) store_row(&smem[nxt + L::at(m.ly + j, m.lx)], q[j]);
  __syncthreads();
  for (int i = tid; i < L::LY * L::LX; i += L::THREADS) {
    const int y = i / L::LX, x = i % L::LX, c = L::at(y, x);
    if (!tile_cell(m, y, x, H, W)) continue;
    const size_t g = f + (size_t)gyv[y] * W + gxv[x];
    out0[g] = smem[nxt + c];
    out1[g] = smem[cur + c];
  }
}

// ---------------------------------------------------------------------------
// The tape replay: one launch per chunk, one (sample, shot) field per
// thread-block cluster of `ranks` blocks (16 for a field of 32 rows or
// more). Block `rank` owns the rows [rank*H/ranks, (rank+1)*H/ranks) of the
// field (a strip of at least 2 rows, the halo depth) at every column; x
// wraps inside the block. In shared memory it keeps two buffers of its
// strip with 2 halo rows above and below, s_k and s_{k-1} (own rows only),
// used in turn, its cells' alpha, t1 and t2, and the field's injection row,
// all loaded once a launch. A step computes s_{k+1} over s_{k-1} in place
// (each cell read and written by one thread), stores each cell to the
// step's tape slot from its register (a warp's stores of one row are one
// coalesced line), and writes the strip's first and last 2 rows straight
// into the halo rows of the ranks above and below (rank 0 wraps to rank
// ranks-1) through distributed shared memory. One cluster barrier a step
// (arrive releases those writes, wait acquires the neighbours') orders the
// block's own rows and its halo rows before the next step. A block writes
// into a neighbour's buffer only the halo rows that the neighbour reads
// after the next barrier, and the neighbour last read them before the
// barrier of the step before. The last step writes no halo rows, so a
// block may leave after it.
//
// A thread takes one column of a band of the strip's rows (as many bands
// of at least kTapeBand rows as keep the block's threads busy; neighbouring
// threads on neighbouring columns) and walks down it with the column's
// s_k at rows y-2 .. y+2 in registers, so a cell reads 9 shared values (6
// of the states, alpha, t1, t2). No global load is left inside a step: a
// cell that waited for one would hold the whole cluster at the barrier.
//
// What bounds it (H100, chip_smoke.py and PERF.md): the tape's bytes,
// (chunk + 3) fields a chunk, would take 2.7 ms a 1000-step pass at the
// headline. Per step a cluster of 16 blocks takes about 1 us for the
// cluster barrier and 2-3 us for its 6200 cells a block (about 50
// instructions a cell, issue-bound), and the 20 fields of the headline run
// in 3 waves of 7 resident clusters. The coefficients live in shared
// memory: in registers (512 threads a block) they spilled, and the design
// that kept them there ran slower. Shared memory is the size limit
// (tape_fits): (5*rows + 9)*Wp floats for the largest strip of `rows`,
// 416x416 or 310x430 and smaller at 16 blocks a field.
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

// The cluster calls of the tape replay: this block's rank in its cluster,
// a pointer into another rank's shared memory at the offset of p in this
// block's, and the cluster barrier in its two halves: arrive (releasing
// this thread's writes, local and remote, to the cluster) and wait (until
// every thread of the cluster has arrived; acquiring their writes).
__device__ __forceinline__ int cluster_rank() {
  return (int)cg::this_cluster().block_rank();
}

__device__ __forceinline__ float* cluster_map(float* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

__device__ __forceinline__ void cluster_arrive() {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#elif !defined(__CUDACC__)
  cg::this_cluster().barrier_arrive();    // the host build's stand-in
#endif
}

__device__ __forceinline__ void cluster_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#elif !defined(__CUDACC__)
  cg::this_cluster().barrier_wait();
#endif
}

constexpr int kTapeThreads = 1024;
constexpr int kTapeBand = 4;       // fewest rows of a band
constexpr int kTapeMaxRanks = 16;  // a non-portable cluster size
constexpr size_t kMaxSmem = 232448;  // 227 KB a block

// First row of rank r's strip.
__host__ __device__ __forceinline__ int strip_start(int r, int ranks,
                                                    int H) {
  return (int)((long long)r * H / ranks);
}

// Rows of the largest strip.
__host__ __device__ __forceinline__ int strip_rows(int ranks, int H) {
  return (H + ranks - 1) / ranks;
}

// The replay of one chunk from its start carry into the tape: chunk + 1
// slots of `slot` cells, slot i = s_{i-1}. p0, p1 hold s_{-1}, s_0 and go
// to slots 0 and 1; steps k = 0 .. chunk-2 write s_{k+1} to slot k+2, so
// the chunk-end state s_chunk, which the taped adjoint never reads, is not
// computed. Grid (ranks, B*ns), clusters of (ranks, 1, 1). Shared memory:
// two buffers of (largest strip + 4 halo rows) x W, then alpha, t1, t2 at
// the strip, and the field's injection row.
__global__ void __launch_bounds__(kTapeThreads, 1) tape_step(
    float* __restrict__ tape, const float* __restrict__ p0,
    const float* __restrict__ p1, const float* __restrict__ alpha,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const float* __restrict__ inj, const float* __restrict__ src, int chunk,
    int ns, int H, int W, int isz, int ranks, long long slot) {
  extern __shared__ float smem[];
  const int rank = cluster_rank();
  const int bs = blockIdx.y;
  const int tid = threadIdx.x;
  const int r0 = strip_start(rank, ranks, H);
  const int rows = strip_start(rank + 1, ranks, H) - r0;
  const int rmax = strip_rows(ranks, H);
  const int bsz = (rmax + 4) * W;        // one state buffer
  const int own = 2 * W;                 // its row 0, after 2 halo rows
  float* const sa = smem + 2 * bsz;      // alpha, t1, t2 at the strip
  float* const s1 = sa + rmax * W;
  float* const s2 = s1 + rmax * W;
  float* const si = s2 + rmax * W;       // the field's injection row
  // Where this strip's first 2 rows go in the rank above (its bottom halo
  // rows) and its last 2 rows in the rank below (its top halo rows), at
  // buffer 0, as offsets from the strip's row 0 there.
  const int up = (rank + ranks - 1) % ranks, dn = (rank + 1) % ranks;
  const int up_rows = strip_start(up + 1, ranks, H) - strip_start(up, ranks, H);
  float* const to_up = cluster_map(smem, up) + own + up_rows * W;
  float* const to_dn = cluster_map(smem, dn) + own - rows * W;
  const size_t f = (size_t)bs * H * W;
  const size_t fs = f + (size_t)r0 * W;    // the strip's first cell
  const size_t cb = (size_t)(bs / ns) * H * W + (size_t)r0 * W;
  const int n = rows * W;
  // This thread's share of a step, worked out once: one column of one of
  // `bands` bands of the strip's rows, as many bands (each of kTapeBand
  // rows or more) as keep the block's threads busy; with W above
  // kTapeThreads, one band and the columns x0, x0 + kTapeThreads, ...
  int bands = kTapeThreads / W;
  if (bands > rows / kTapeBand) bands = rows / kTapeBand;
  if (bands < 1) bands = 1;
  const bool wide = W > kTapeThreads;
  const int band = wide ? 0 : tid / W;
  const int x0 = wide ? tid : tid % W;
  const int xstep = wide ? kTapeThreads : W;
  const bool busy = band < bands;
  const int ya = band * rows / bands, yb = (band + 1) * rows / bands;
  // s_{-1} at the strip of buffer 1 and the coefficients; s_0 at the strip
  // and its halo rows of buffer 0; both states to their tape slots.
  for (int i = tid; i < n; i += kTapeThreads) {
    const float v = p0[fs + i];
    smem[bsz + own + i] = v;
    tape[fs + i] = v;
    sa[i] = alpha[cb + i];
    s1[i] = t1[cb + i];
    s2[i] = t2[cb + i];
  }
  for (int i = tid; i < (rows + 4) * W; i += kTapeThreads) {
    const int y = i / W - 2, x = i % W;
    const float v = p1[f + (size_t)wrap(r0 + y, H) * W + x];
    smem[own + y * W + x] = v;
    if (y >= 0 && y < rows) tape[slot + fs + y * W + x] = v;
  }
  for (int i = tid; i < W; i += kTapeThreads) si[i] = inj[(size_t)bs * W + i];
  float sk = src[0];    // src[k], read a step ahead
  // Every block of the cluster is running (before any write to another's
  // shared memory) and has loaded its strip.
  cluster_arrive();
  cluster_wait();
  int cur = 0, nxt = bsz;    // offsets of the buffers of s_k and s_{k-1}
  for (int k = 0; k + 1 < chunk; ++k) {
    const float sk_next = src[k + 1];
    const bool halo = k + 2 < chunk;    // the next step reads halo rows
    // s_k is only read, and s_{k-1} only at a thread's own cells: no
    // pointer aliases another, so a row's loads need not wait for the
    // stores of the row before.
    const float* __restrict__ c = &smem[cur + own];
    float* __restrict__ o = &smem[nxt + own];
    float* __restrict__ out = tape + (size_t)(k + 2) * slot + fs;
    float* const hu = to_up + nxt;    // + row*W + x
    float* const hd = to_dn + nxt;
    for (int x = x0; busy && x < W; x += xstep) {
      const int xm1 = x == 0 ? W - 1 : x - 1;
      const int xm2 = xm1 == 0 ? W - 1 : xm1 - 1;
      const int xp1 = x == W - 1 ? 0 : x + 1;
      const int xp2 = xp1 == W - 1 ? 0 : xp1 + 1;
      // s_k at rows y-2 .. y+1 of column x, rolled down a row a cell.
      float ym2 = c[(ya - 2) * W + x], ym1 = c[(ya - 1) * W + x];
      float cc = c[ya * W + x], yp1 = c[(ya + 1) * W + x];
#pragma unroll 2
      for (int y = ya; y < yb; ++y) {
        const int at = y * W + x;
        const float yp2 = c[at + 2 * W];
        const float* r = c + y * W;
        const float lap = kC2 * (((ym1 + yp1) + r[xm1]) + r[xp1]) +
                          kC3 * (((ym2 + yp2) + r[xm2]) + r[xp2]);
        float p = (s1[at] * cc - s2[at] * o[at]) + sa[at] * lap;
        if (r0 + y == isz) p = p + si[x] * sk;
        o[at] = p;
        out[at] = p;
        if (halo) {
          if (y < 2) hu[at] = p;
          if (y >= rows - 2) hd[at] = p;
        }
        ym2 = ym1;
        ym1 = cc;
        cc = yp1;
        yp1 = yp2;
      }
    }
    if (halo) {
      cluster_arrive();
      cluster_wait();
    }
    const int t = cur; cur = nxt; nxt = t;
    sk = sk_next;
  }
}

// ---------------------------------------------------------------------------
// The tape replay of a field past tape_step_stream's size limit
// (stream_fits: the strip's two states over 227 KB, e.g. 680x680; the TPU
// kernel keeps whole fields in up to 100 MB of VMEM, so the JAX package
// has no such limit). Nothing stays in shared memory: one launch per FD
// step over a grid of 32x8-cell tiles of every (sample, shot) field, one
// thread a cell, reading s_{k-1} and s_k from the tape's slots k and k+1
// in device memory (the L2 holds them for the neighbours' reads) and
// writing s_{k+1} to slot k+2. The chunk + 1 slots, the arithmetic and its
// fp32 grouping are tape_step's, so the three instantiations write the
// same tape bit for bit. What bounds it: the same tape bytes as tape_step
// (the slots written once), but each step also reads two slots back, and
// the launches are chunk - 1 a chunk. It stays as the twin of the cluster kernels for any
// size (at 420x420, forced, it is the yardstick of tape_step_stream).
// ---------------------------------------------------------------------------

constexpr int kTapeGlobalX = 32, kTapeGlobalY = 8;

// Step k of the replay at every cell: slots k, k+1 (s_{k-1}, s_k) in, slot
// k+2 out; at k = 0 the carry p0, p1 is read in their place and also
// copied to slots 0 and 1. A chunk of one step writes only the carry (the
// launch with k = 0 and chunk = 1). Grid (ceil(W/32), ceil(H/8), B*ns);
// `slot` = B*ns*H*W cells.
__global__ void __launch_bounds__(kTapeGlobalX * kTapeGlobalY)
    tape_step_global(float* __restrict__ tape, const float* __restrict__ p0,
                     const float* __restrict__ p1,
                     const float* __restrict__ alpha,
                     const float* __restrict__ t1,
                     const float* __restrict__ t2,
                     const float* __restrict__ inj,
                     const float* __restrict__ src, int k, int chunk, int ns,
                     int H, int W, int isz, long long slot) {
  const int x = blockIdx.x * kTapeGlobalX + threadIdx.x;
  const int y = blockIdx.y * kTapeGlobalY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int bs = blockIdx.z;
  const size_t hw = (size_t)H * W;
  const size_t f = (size_t)bs * hw;        // this field's first cell
  const size_t at = f + (size_t)y * W + x;
  if (k == 0) {
    tape[at] = p0[at];
    tape[slot + at] = p1[at];
  }
  if (k + 1 >= chunk) return;
  const size_t c = (size_t)(bs / ns) * hw + (size_t)y * W + x;
  const float* prev = k == 0 ? p0 : tape + k * slot;
  const float* s = (k == 0 ? p1 : tape + (k + 1) * slot) + f;
  const int ym1 = wrap(y - 1, H), ym2 = wrap(y - 2, H);
  const int yp1 = wrap(y + 1, H), yp2 = wrap(y + 2, H);
  const int xm1 = wrap(x - 1, W), xm2 = wrap(x - 2, W);
  const int xp1 = wrap(x + 1, W), xp2 = wrap(x + 2, W);
  const float* r = s + (size_t)y * W;
  const float lap =
      kC2 * (((s[(size_t)ym1 * W + x] + s[(size_t)yp1 * W + x]) + r[xm1]) +
             r[xp1]) +
      kC3 * (((s[(size_t)ym2 * W + x] + s[(size_t)yp2 * W + x]) + r[xm2]) +
             r[xp2]);
  float p = (t1[c] * r[x] - t2[c] * prev[at]) + alpha[c] * lap;
  if (y == isz) p = p + inj[(size_t)bs * W + x] * src[k];
  tape[(k + 2) * slot + at] = p;
}

// ---------------------------------------------------------------------------
// tape_step_stream<NP>: the tape replay of a field past tape_step's limit,
// one launch per chunk as tape_step, for fields whose states fit a
// cluster's shared memory but whose three coefficient planes do not all
// fit beside them (420x420: a strip of 27 rows and its planes need 241,920
// bytes a block). The scheme is tape_step's: one (sample, shot) field a
// cluster of up to 16 blocks, a strip of rows a block, two state buffers
// with 2 halo rows a side used in turn, s_{k+1} computed over s_{k-1} in
// place, each new value stored to its tape slot from its register, the
// strip's first and last 2 rows written into the neighbours' halo rows
// through distributed shared memory, one cluster barrier a step.
//
// What differs. NP of the planes (alpha, t1, t2 in that order: alpha and t1
// at NP = 2) stay in shared memory with the states; the other 3 - NP are
// read from device memory, where the L2 holds them (2.1 MB a sample at
// 420x420, shared by its shots). A cell that waited for such a load would
// hold the whole cluster at the barrier, so the loads run ahead of their
// use: a thread walks one column of a band of rows (and with W above
// kTapeThreads the columns x, x + kTapeThreads, ... of the whole strip),
// the same cells every step, and keeps the streamed values of its next
// AHEAD cells in registers (4 with one streamed plane, fewer with more, so
// that the registers of 1024 threads hold them), loading the one after
// them as it takes each cell; past its last cell it wraps to its first, so
// a step begins with its first rows' values already loaded (the planes do
// not change between steps). A column is walked in groups of kStreamGroup
// rows and a shorter first group, each a compile-time count of rows
// (stream_rows<NP, R>), so its cells run straight with no per-cell guard;
// the source row's injection is added after the column by the thread that
// owns the cell (its tape cell stored again), and the rows pushed to the
// neighbours are read back after it, as in probe_resident
// (layout_probe.cu), whose 32-bit st.shared::cluster addresses it also
// takes. Limits (stream_fits): a block's shared memory, (2*(rows + 4) +
// NP*rows + 1)*W floats for a strip of `rows` (the states, the planes, the
// injection row), within 227 KB: at 16 blocks two planes fit to 420x420
// (196,560 bytes), none to 640x640; larger fields take tape_step_global.
//
// What bounds it: the same bytes as tape_step (the chunk + 1 slots), the
// streamed planes' L2 reads (3.5 MB a step at 420x420, B=1, ns=5, one
// plane), and per step a block's cells (11,340 at 420x420) and the cluster
// barrier, in one wave of clusters (5 at B=1). On an H100 (PERF.md) a step
// at 420x420 takes 4.7 us: the walk 4.0 (about 31 instructions a cell;
// the streamed loads, the tape stores and the pushes each 0.5-0.8 of it)
// and the barrier 0.7; a launch 11 us more; 25% of the bytes' bound.
// ---------------------------------------------------------------------------

constexpr int kStreamGroup = 4;   // rows of a group of a thread's walk

// A float in another rank's shared memory: on the card a 32-bit
// shared::cluster address (mapa), stored to with st.shared::cluster, so
// that it costs one register and no generic-address translation; in the
// host build a pointer.
#ifdef CUDA_HOST_EMULATION
using dsmem_addr = float*;
__device__ __forceinline__ dsmem_addr dsmem_map(float* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}
__device__ __forceinline__ dsmem_addr dsmem_at(dsmem_addr a, int i) {
  return a + i;
}
__device__ __forceinline__ void dsmem_store(dsmem_addr a, int i, float v) {
  a[i] = v;
}
#else
using dsmem_addr = unsigned;
__device__ __forceinline__ dsmem_addr dsmem_map(float* p, int rank) {
  unsigned a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a)
      : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}
// The float i floats past a.
__device__ __forceinline__ dsmem_addr dsmem_at(dsmem_addr a, int i) {
  return a + 4 * i;
}
// Ordered before the cluster barrier's arrive, whose asm clobbers memory.
__device__ __forceinline__ void dsmem_store(dsmem_addr a, int i, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a + 4 * i), "f"(v));
}
#endif

// A band's threads: W rounded up to whole warps, so that the threads of a
// warp share one band (and one count of rows).
__host__ __device__ __forceinline__ int stream_band_threads(int W) {
  return (W + 31) & ~31;
}

// Bands of a strip of `rows` rows at width W: one past kTapeThreads
// columns.
__host__ __device__ __forceinline__ int stream_bands(int rows, int W) {
  const int b = kTapeThreads / stream_band_threads(W);
  return b < 1 ? 1 : b < rows ? b : rows;
}

// A thread's walk: its current cell's offset `at` from the strip's cell
// (0, 0) (the same in the state buffers and the resident planes), the
// column's s_k at rows y-2 .. y+1, and its streamed planes' values of its
// next AHEAD cells (q[i][0] the current cell's), with the offset of
// the cell to load next (`ahead`, from the strip's cell (0, 0) of a plane),
// the rows left in that column, and that column's index among the
// thread's `cols` columns, the first at `base`.
template <int NP>
struct StreamWalk {
  static constexpr int NS = 3 - NP;
  static constexpr int AHEAD = NS == 1 ? 4 : NS == 2 ? 2 : 1;
  static constexpr int GROUP = kStreamGroup;
  int at, ahead, left, col, cols, base;
  float ym2, ym1, cc, yp1;
  float q[NS][AHEAD];
};

// The walk's next load: the streamed values of the cell at `ahead`, then
// `ahead` one row on, or past a column's nb rows to the next column's
// first (after the last column, the first's).
template <int NP>
__device__ __forceinline__ void stream_load(
    StreamWalk<NP>& w, const float* const (&sp)[3 - NP], int a, int W,
    int nb) {
#pragma unroll
  for (int i = 0; i < 3 - NP; ++i) w.q[i][a] = sp[i][w.ahead];
  w.ahead += W;
  if (--w.left == 0) {
    w.left = nb;
    w.col = w.col + 1 == w.cols ? 0 : w.col + 1;
    w.ahead = w.base + w.col * kTapeThreads;
  }
}

// R rows of a thread's walk (R a constant, no guard): s_{k+1} over s_{k-1}
// at each, in tape_step's grouping, into o and the tape slot out. c, o:
// s_k and s_{k-1} at the strip's cell (0, 0); res: the resident planes
// there, `plane` floats apart; sp: the streamed planes there; dm1 .. dp2:
// the wrapped x neighbours as offsets from the cell.
template <int NP, int R>
__device__ __forceinline__ void stream_rows(
    StreamWalk<NP>& w, const float* __restrict__ c, float* __restrict__ o,
    float* __restrict__ out, const float* __restrict__ res, int plane,
    const float* const (&sp)[3 - NP], int W, int dm1, int dm2, int dp1,
    int dp2, int nb) {
  constexpr int NS = 3 - NP, AHEAD = StreamWalk<NP>::AHEAD;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int at = w.at;
    const float* r = c + at;
    const float yp2 = r[2 * W];
    const float lap = kC2 * (((w.ym1 + w.yp1) + r[dm1]) + r[dp1]) +
                      kC3 * (((w.ym2 + yp2) + r[dm2]) + r[dp2]);
    float cf[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      cf[i] = i < NP ? res[i * plane + at] : w.q[i < NP ? 0 : i - NP][0];
    const float p = (cf[1] * w.cc - cf[2] * o[at]) + cf[0] * lap;
    o[at] = p;
    out[at] = p;
    w.ym2 = w.ym1;
    w.ym1 = w.cc;
    w.cc = w.yp1;
    w.yp1 = yp2;
    w.at = at + W;
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int a = 0; a + 1 < AHEAD; ++a) w.q[i][a] = w.q[i][a + 1];
    stream_load<NP>(w, sp, AHEAD - 1, W, nb);
  }
}

// Grid (ranks, B*ns), clusters of (ranks, 1, 1), kTapeThreads a block. The
// chunk's replay, as tape_step: chunk + 1 slots of `slot` cells, slot i =
// s_{i-1}; p0, p1 (s_{-1}, s_0) go to slots 0 and 1, steps k = 0 ..
// chunk-2 write s_{k+1} to slot k+2. Shared memory: two buffers of
// (largest strip + 4 halo rows) x W, then NP planes at the strip, then the
// field's injection row.
template <int NP>
__global__ void __launch_bounds__(kTapeThreads, 1) tape_step_stream(
    float* __restrict__ tape, const float* __restrict__ p0,
    const float* __restrict__ p1, const float* __restrict__ alpha,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const float* __restrict__ inj, const float* __restrict__ src, int chunk,
    int ns, int H, int W, int isz, int ranks, long long slot) {
  extern __shared__ float smem[];
  constexpr int NS = 3 - NP;
  const int rank = cluster_rank();
  const int bs = blockIdx.y;
  const int tid = threadIdx.x;
  const int r0 = strip_start(rank, ranks, H);
  const int rows = strip_start(rank + 1, ranks, H) - r0;
  const int rmax = strip_rows(ranks, H);
  const int bsz = (rmax + 4) * W;        // one state buffer
  const int own = 2 * W;                 // its row 0, after 2 halo rows
  const int plane = rmax * W;            // a resident plane
  float* const res = smem + 2 * bsz;
  float* const si = res + NP * plane;    // the field's injection row
  const size_t f = (size_t)bs * H * W;
  const size_t fs = f + (size_t)r0 * W;    // the strip's first cell
  const size_t cb = (size_t)(bs / ns) * H * W + (size_t)r0 * W;
  const float* const planes[3] = {alpha + cb, t1 + cb, t2 + cb};
  const float* sp[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) sp[i] = planes[NP + i];
  // Where this strip's first 2 rows go in the rank above (its bottom halo
  // rows) and its last 2 rows in the rank below (its top halo rows), at
  // buffer 0, as offsets from the strip's row 0 there.
  const int up = (rank + ranks - 1) % ranks, dn = (rank + 1) % ranks;
  const int up_rows = strip_start(up + 1, ranks, H) - strip_start(up, ranks, H);
  const dsmem_addr to_up = dsmem_at(dsmem_map(smem, up), own + up_rows * W);
  const dsmem_addr to_dn = dsmem_at(dsmem_map(smem, dn), own - rows * W);
  // This thread's share of a step, worked out once: column x (and x +
  // kTapeThreads, ... below W: `cols` columns) of one of `bands` bands of
  // the strip's rows, rows ya .. ya + nb - 1; its rows among the strip's
  // first 2 (ya .. top - 1) and last 2 (bot .. ya + nb - 1), which go to
  // the neighbours; its row sy of the band, if that is the source row.
  const int bands = stream_bands(rows, W);
  const int bt = stream_band_threads(W);
  const int band = tid / bt, x = tid % bt;
  const bool busy = band < bands && x < W;
  const int ya = busy ? band * rows / bands : 0;
  const int nb = busy ? (band + 1) * rows / bands - ya : 0;
  const int cols = busy ? (W - x + kTapeThreads - 1) / kTapeThreads : 0;
  const int top = ya + nb < 2 ? ya + nb : 2;
  const int bot = ya > rows - 2 ? ya : rows - 2;
  const int sy = isz - r0 - ya;
  const bool has_src = sy >= 0 && sy < nb;
  // s_{-1} at the strip of buffer 1 and the resident planes; s_0 at the
  // strip and its halo rows of buffer 0; both states to their tape slots.
  const int n = rows * W;
  for (int i = tid; i < n; i += kTapeThreads) {
    const float v = p0[fs + i];
    smem[bsz + own + i] = v;
    tape[fs + i] = v;
#pragma unroll
    for (int j = 0; j < NP; ++j) res[j * plane + i] = planes[j][i];
  }
  for (int i = tid; i < (rows + 4) * W; i += kTapeThreads) {
    const int y = i / W - 2, xx = i % W;
    const float v = p1[f + (size_t)wrap(r0 + y, H) * W + xx];
    smem[own + y * W + xx] = v;
    if (y >= 0 && y < rows) tape[slot + fs + y * W + xx] = v;
  }
  for (int i = tid; i < W; i += kTapeThreads) si[i] = inj[(size_t)bs * W + i];
  // The streamed values of the walk's first AHEAD cells (wrapping
  // in a walk of fewer), and the cell to load next.
  StreamWalk<NP> w;
  w.base = ya * W + x;
  w.cols = cols;
  w.col = 0;
  w.left = nb;
  w.ahead = w.base;
  if (busy && nb > 0) {
#pragma unroll
    for (int a = 0; a < StreamWalk<NP>::AHEAD; ++a)
      stream_load<NP>(w, sp, a, W, nb);
  }
  constexpr int GROUP = StreamWalk<NP>::GROUP;
  const int rem = nb % GROUP, groups = nb / GROUP;
  float sk = src[0];    // src[k], read a step ahead
  // Every block of the cluster is running (before any write to another's
  // shared memory) and has loaded its strip.
  cluster_arrive();
  cluster_wait();
  int cur = 0, nxt = bsz;    // offsets of the buffers of s_k and s_{k-1}
  for (int k = 0; k + 1 < chunk; ++k) {
    const float sk_next = src[k + 1];
    const bool halo = k + 2 < chunk;    // the next step reads halo rows
    const float* c = smem + cur + own;
    float* const o = smem + nxt + own;
    float* const out = tape + (size_t)(k + 2) * slot + fs;
    for (int col = 0; col < cols; ++col) {
      const int first = w.base + col * kTapeThreads;
      const int xc = x + col * kTapeThreads;    // the column
      const int dm1 = xc == 0 ? W - 1 : -1, dp1 = xc == W - 1 ? 1 - W : 1;
      const int dm2 = xc < 2 ? W - 2 : -2, dp2 = xc >= W - 2 ? 2 - W : 2;
      w.at = first;
      w.ym2 = c[first - 2 * W];
      w.ym1 = c[first - W];
      w.cc = c[first];
      w.yp1 = c[first + W];
      switch (rem) {
#define RDT_STREAM_ROWS(R)                                                    \
  stream_rows<NP, R>(w, c, o, out, res, plane, sp, W, dm1, dm2, dp1, dp2, nb)
        case 1: RDT_STREAM_ROWS(1); break;
        case 2: RDT_STREAM_ROWS(2); break;
        case 3: RDT_STREAM_ROWS(3); break;
        default: break;
      }
#pragma unroll 1
      for (int g = 0; g < groups; ++g) RDT_STREAM_ROWS(GROUP);
#undef RDT_STREAM_ROWS
      // The source row's injection, at the cell of the thread that owns it,
      // in the plain version's order (the step's value, then + inj*src).
      if (has_src) {
        const int cell = first + sy * W;
        const float p = o[cell] + si[xc] * sk;
        o[cell] = p;
        out[cell] = p;
      }
      // The column's rows among the strip's first and last 2 into the
      // neighbours' halo rows, which the next step reads; each cell read
      // back by the thread that wrote it.
      if (halo) {
        const dsmem_addr hu = dsmem_at(to_up, nxt + first);
        const dsmem_addr hd = dsmem_at(to_dn, nxt + first);
        for (int j = 0; ya + j < top; ++j)
          dsmem_store(hu, j * W, o[first + j * W]);
        for (int j = bot - ya; j < nb; ++j)
          dsmem_store(hd, j * W, o[first + j * W]);
      }
    }
    if (!halo) break;    // the last step: no rows are read after it
    cluster_arrive();
    cluster_wait();
    sk = sk_next;
    const int t = cur; cur = nxt; nxt = t;
  }
}

// The adjoint's blocking: 4x2 cells a thread, 16x16 threads, a 64-column,
// 32-row window (48x16 tile at U=4); two windows each of s_{m-1} and of
// alpha*v, the alpha, t1, t2 and 1/t2 windows, the tile's running sums and
// the window's rows and columns (108 KB of shared memory).
using BwdL = Layout<4, 2, 16, 16>;

// Reversed steps k_hi down to k_hi-n+1 (n <= unroll; step k rebuilds
// s_{k-1} from s_{k+1} and s_k) of the tape-free adjoint, one block per
// (tile, sample*shot).
//   u_in, v_in: cotangents of s_{m-1}, s_m (m = k_hi + 1; v before the
//     receiver injection); u_out, v_out: those of the group's last step.
//   s_in, s1_in: s_m, s_{m-1}; s_out, s1_out: the group's last pair.
//   pa, p1, p2: this shot's running alpha, t1 and t2 cotangents
//     (B, ns, H, W), added to in step order; ginj: (B, ns, 1, W).
// A thread keeps s_m, s_{m-1}, u and v of its cells in registers, s_{m-1}
// and alpha*v (v after the receiver injection) also in the shared windows
// its neighbours read; the tile's running sums stay in shared memory, each
// row of a micro-tile read and written by its own thread. Per step:
//   s_{m-2} = (t1*s_{m-1} + alpha*L(s_{m-1}) + inj - s_m) / t2 (into the
//     s_m registers, then s_m and s_{m-1} swap names), the tile's sums;
//   v' = u + t1*v + L(alpha*v), u' = -t2*v, and the next step's receiver
//     cotangent added to v'.
__global__ void __launch_bounds__(BwdL::THREADS, 2) bwd_reverse_step(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ s_in, const float* __restrict__ s1_in,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ s_out, float* __restrict__ s1_out,
    float* __restrict__ pa, float* __restrict__ p1, float* __restrict__ p2,
    float* __restrict__ ginj, const float* __restrict__ grec,
    const float* __restrict__ alpha, const float* __restrict__ t1,
    const float* __restrict__ t2, const float* __restrict__ inj,
    const float* __restrict__ src, int k_hi, int n, int unroll, int ns,
    int H, int W, int isz, int igz, int g0, int ng, int chunk) {
  using L = BwdL;
  constexpr int MX = L::MX, MY = L::MY;
  extern __shared__ float smem[];
  // Window offsets in smem: s_{m-1} and alpha*v each in turn, then alpha,
  // t1, t2, then the running sums.
  int s1c = 0, s1n = L::SIZE, wc = 2 * L::SIZE, wn = 3 * L::SIZE;
  constexpr int WA = 4 * L::SIZE, W1 = 5 * L::SIZE, W2 = 6 * L::SIZE;
  constexpr int WI = 7 * L::SIZE;      // 1/t2 at each thread's own cells
  float* sums = smem + 8 * L::SIZE;   // 3 arrays of LY x LX, no pads
  Cells<L> m(unroll);
  const int bs = blockIdx.z;
  const size_t f = (size_t)bs * H * W;
  const size_t cb = (size_t)(bs / ns) * H * W;
  const float* gr = grec + (size_t)bs * chunk * ng;
  const float* injr = inj + (size_t)bs * W;
  float* ginjr = ginj + (size_t)bs * W;
  // The window, in coalesced order: s_{m-1} into its current window, s_m,
  // u and v into the other three state windows (each thread then reads its
  // own cells), alpha, t1, t2, and the tile's running sums.
  int* gyv = reinterpret_cast<int*>(smem + 8 * L::SIZE + 3 * L::LY * L::LX);
  int* gxv = gyv + L::LY;
  window_index<L>(gyv, gxv, m.y0 - m.h, m.x0 - m.h, H, W);
  zero_pads<L>(smem, 4);
  __syncthreads();
  m.classify(gyv, gxv, H, W, isz, igz, g0, ng);
  const int tid = threadIdx.y * L::NTX + threadIdx.x;
  for (int i = tid; i < L::LY * L::LX; i += L::THREADS) {
    const int y = i / L::LX, x = i % L::LX, c = L::at(y, x);
    const size_t gc = cb + (size_t)gyv[y] * W + gxv[x];
    const size_t g = f + (size_t)gyv[y] * W + gxv[x];
    copy_async(&smem[s1c + c], s1_in + g);
    copy_async(&smem[s1n + c], s_in + g);
    copy_async(&smem[wn + c], u_in + g);
    copy_async(&smem[wc + c], v_in + g);
    copy_async(&smem[WA + c], alpha + gc);
    copy_async(&smem[W1 + c], t1 + gc);
    copy_async(&smem[W2 + c], t2 + gc);
    if (tile_cell(m, y, x, H, W)) {
      copy_async(&sums[i], pa + g);
      copy_async(&sums[i + L::LY * L::LX], p1 + g);
      copy_async(&sums[i + 2 * L::LY * L::LX], p2 + g);
    }
  }
  copy_wait();
  __syncthreads();
  float sm[MY][MX], s1[MY][MX], u[MY][MX], v[MY][MX];
#pragma unroll
  for (int j = 0; j < MY; ++j) {
    float a[MX], w[MX], c2[MX];
    load_row(&smem[s1c + L::at(m.ly + j, m.lx)], s1[j]);
    load_row(&smem[s1n + L::at(m.ly + j, m.lx)], sm[j]);
    load_row(&smem[wn + L::at(m.ly + j, m.lx)], u[j]);
    load_row(&smem[wc + L::at(m.ly + j, m.lx)], v[j]);
    load_row(&smem[WA + L::at(m.ly + j, m.lx)], a);
    load_row(&smem[W2 + L::at(m.ly + j, m.lx)], c2);
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      if (m.rec(j, i))
        v[j][i] = v[j][i] + gr[(size_t)k_hi * ng + (m.gx(i) - g0)];
      w[i] = a[i] * v[j][i];
      c2[i] = 1.0f / c2[i];
    }
    store_row(&smem[wc + L::at(m.ly + j, m.lx)], w);
    store_row(&smem[WI + L::at(m.ly + j, m.lx)], c2);
  }
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    const int k = k_hi - s;
    if (m.live(2 * (unroll - n + 1 + s))) {
      const float sk = src[k];
      {
        const Edges<L> e(&smem[s1c], m.ly, m.lx);
#pragma unroll
        for (int j = 0; j < MY; ++j) {
          float l2, l1, r1, r2, a[MX], c1[MX], inv_t2[MX];
          load_pair(&smem[s1c + L::at(m.ly + j, m.lx - 2)], l2, l1);
          load_pair(&smem[s1c + L::at(m.ly + j, m.lx + MX)], r1, r2);
          load_row(&smem[WA + L::at(m.ly + j, m.lx)], a);
          load_row(&smem[W1 + L::at(m.ly + j, m.lx)], c1);
          load_row(&smem[WI + L::at(m.ly + j, m.lx)], inv_t2);
          // The row's running sums (read whole, kept at its own cells).
          const int r = (m.ly + j) * L::LX + m.lx;
          float qa[MX], q1[MX], q2[MX];
          if (m.oy(j)) {
            load_row(&sums[r], qa);
            load_row(&sums[r + L::LY * L::LX], q1);
            load_row(&sums[r + 2 * L::LY * L::LX], q2);
          }
#pragma unroll
          for (int i = 0; i < MX; ++i) {
            const float vv = v[j][i];
            const float sv = s1[j][i];
            const float ls = lap_cell<L>(s1, e, l2, l1, r1, r2, j, i);
            const float inj_field =
                m.src(j) ? injr[m.gx(i)] * sk : 0.0f;
            const float s2 = (((c1[i] * sv + a[i] * ls) + inj_field) -
                              sm[j][i]) * inv_t2[i];
            if (m.oy(j) && m.ox(i)) {
              qa[i] = qa[i] + vv * ls;
              q1[i] = q1[i] + vv * sv;
              q2[i] = q2[i] - vv * s2;
              if (m.src(j)) ginjr[m.gx(i)] = ginjr[m.gx(i)] + vv * sk;
            }
            sm[j][i] = s2;
          }
          if (m.oy(j)) {
            store_row(&sums[r], qa);
            store_row(&sums[r + L::LY * L::LX], q1);
            store_row(&sums[r + 2 * L::LY * L::LX], q2);
          }
        }
      }
      // s_m <- s_{m-1}, s_{m-1} <- s_{m-2}.
#pragma unroll
      for (int j = 0; j < MY; ++j)
#pragma unroll
        for (int i = 0; i < MX; ++i) {
          const float t = sm[j][i];
          sm[j][i] = s1[j][i];
          s1[j][i] = t;
        }
      {
        float w[MY][MX];
#pragma unroll
        for (int j = 0; j < MY; ++j) {
          float a[MX];
          load_row(&smem[WA + L::at(m.ly + j, m.lx)], a);
#pragma unroll
          for (int i = 0; i < MX; ++i) w[j][i] = a[i] * v[j][i];
        }
        const Edges<L> e(&smem[wc], m.ly, m.lx);
#pragma unroll
        for (int j = 0; j < MY; ++j) {
          float l2, l1, r1, r2, c1[MX], c2[MX];
          load_pair(&smem[wc + L::at(m.ly + j, m.lx - 2)], l2, l1);
          load_pair(&smem[wc + L::at(m.ly + j, m.lx + MX)], r1, r2);
          load_row(&smem[W1 + L::at(m.ly + j, m.lx)], c1);
          load_row(&smem[W2 + L::at(m.ly + j, m.lx)], c2);
          const bool rec_next = s + 1 < n;
#pragma unroll
          for (int i = 0; i < MX; ++i) {
            const float vv = v[j][i];
            float nv = (u[j][i] + c1[i] * vv) +
                       lap_cell<L>(w, e, l2, l1, r1, r2, j, i);
            if (rec_next && m.rec(j, i))
              nv = nv + gr[(size_t)(k - 1) * ng + (m.gx(i) - g0)];
            u[j][i] = -c2[i] * vv;
            v[j][i] = nv;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < MY; ++j) {
        float a[MX], w[MX];
        load_row(&smem[WA + L::at(m.ly + j, m.lx)], a);
#pragma unroll
        for (int i = 0; i < MX; ++i) w[i] = a[i] * v[j][i];
        store_row(&smem[s1n + L::at(m.ly + j, m.lx)], s1[j]);
        store_row(&smem[wn + L::at(m.ly + j, m.lx)], w);
      }
    }
    __syncthreads();
    int t;
    t = s1c; s1c = s1n; s1n = t;
    t = wc; wc = wn; wn = t;
  }
  // s_{m-1} is in its current window at every live cell; s_m, u and v go
  // to the other three, then the tile leaves in coalesced order.
#pragma unroll
  for (int j = 0; j < MY; ++j) {
    store_row(&smem[wc + L::at(m.ly + j, m.lx)], sm[j]);
    store_row(&smem[s1n + L::at(m.ly + j, m.lx)], u[j]);
    store_row(&smem[wn + L::at(m.ly + j, m.lx)], v[j]);
  }
  __syncthreads();
  for (int i = tid; i < L::LY * L::LX; i += L::THREADS) {
    const int y = i / L::LX, x = i % L::LX, c = L::at(y, x);
    if (!tile_cell(m, y, x, H, W)) continue;
    const size_t g = f + (size_t)gyv[y] * W + gxv[x];
    s1_out[g] = smem[s1c + c];
    s_out[g] = smem[wc + c];
    u_out[g] = smem[s1n + c];
    v_out[g] = smem[wn + c];
    pa[g] = sums[i];
    p1[g] = sums[i + L::LY * L::LX];
    p2[g] = sums[i + 2 * L::LY * L::LX];
  }
}

// The shot sum of the adjoint's per-shot coefficient cotangents, once per
// chunk: galpha[b] = ((pa[b, 0] + pa[b, 1]) + ...) + pa[b, ns-1], likewise
// gt1 and gt2, in one fixed order and with no atomics. One thread takes 4
// consecutive cells of one sample's plane and issues the loads of up to
// MAXNS shots of all three inputs before it adds them (16-byte loads when
// every plane starts 16-byte aligned, hw % 4 == 0; else, and at a plane's
// ragged end, one cell at a time). It reads 3 (B, ns) and writes 3 (B, 1)
// planes: bound by bytes.
constexpr int kSumThreads = 128;

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  float4 r;
  r.x = a.x + b.x; r.y = a.y + b.y; r.z = a.z + b.z; r.w = a.w + b.w;
  return r;
}

// acc = x at shot 0, acc + x at every later shot: the sum in shot order.
__device__ __forceinline__ void shot_add(float& acc, float x, int shot) {
  acc = shot == 0 ? x : acc + x;
}

__device__ __forceinline__ void shot_add(float4& acc, const float4& x,
                                         int shot) {
  acc = shot == 0 ? x : add4(acc, x);
}

// Shots s0 .. s0+MAXNS-1 (those below ns) of the three inputs at offset o,
// loaded first, then added to acc in shot order.
template <int MAXNS, class T>
__device__ __forceinline__ void sum_batch(const float* const (&in)[3],
                                          T (&acc)[3], size_t o, int s0,
                                          int ns, int hw) {
  T x[3][MAXNS];
#pragma unroll
  for (int s = 0; s < MAXNS; ++s) {
    if (s0 + s >= ns) break;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      x[a][s] = *reinterpret_cast<const T*>(in[a] + o +
                                            (size_t)(s0 + s) * hw);
  }
#pragma unroll
  for (int s = 0; s < MAXNS; ++s) {
    if (s0 + s >= ns) break;
#pragma unroll
    for (int a = 0; a < 3; ++a) shot_add(acc[a], x[a][s], s0 + s);
  }
}

template <int MAXNS>
__global__ void __launch_bounds__(kSumThreads) sum_shots(
    const float* __restrict__ pa, const float* __restrict__ p1,
    const float* __restrict__ p2, float* __restrict__ galpha,
    float* __restrict__ gt1, float* __restrict__ gt2, int B, int ns,
    int hw) {
  const int per = (hw + 3) / 4;         // groups of 4 cells per plane
  const int q = blockIdx.x * kSumThreads + threadIdx.x;
  if (q >= B * per) return;
  const int b = q / per, c = 4 * (q - b * per);
  const float* const in[3] = {pa, p1, p2};
  float* const out[3] = {galpha, gt1, gt2};
  const size_t o = (size_t)b * ns * hw + c, r = (size_t)b * hw + c;
  if (hw % 4 == 0) {
    float4 acc[3];
    for (int s0 = 0; s0 < ns; s0 += MAXNS)
      sum_batch<MAXNS>(in, acc, o, s0, ns, hw);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      *reinterpret_cast<float4*>(out[a] + r) = acc[a];
    return;
  }
  const int cells = hw - c < 4 ? hw - c : 4;
  for (int e = 0; e < cells; ++e) {
    float acc[3];
    for (int s0 = 0; s0 < ns; s0 += MAXNS)
      sum_batch<MAXNS>(in, acc, o + e, s0, ns, hw);
#pragma unroll
    for (int a = 0; a < 3; ++a) out[a][r + e] = acc[a];
  }
}

// Launch sum_shots on stream st, its loads unrolled over the shot count
// (in batches of 8 beyond 8 shots). Returns the launch error, 0 if none.
inline int launch_sum_shots(const float* pa, const float* p1, const float* p2,
                            float* galpha, float* gt1, float* gt2, int B,
                            int ns, int hw, cudaStream_t st) {
  const long long groups = (long long)B * ((hw + 3) / 4);
  const unsigned grid = (unsigned)((groups + kSumThreads - 1) / kSumThreads);
#define RDT_SUM_SHOTS(N)                                                   \
  sum_shots<N><<<grid, kSumThreads, 0, st>>>(pa, p1, p2, galpha, gt1, gt2, \
                                             B, ns, hw)
  switch (ns) {
    case 1: RDT_SUM_SHOTS(1); break;
    case 2: RDT_SUM_SHOTS(2); break;
    case 3: RDT_SUM_SHOTS(3); break;
    case 4: RDT_SUM_SHOTS(4); break;
    case 5: RDT_SUM_SHOTS(5); break;
    case 6: RDT_SUM_SHOTS(6); break;
    case 7: RDT_SUM_SHOTS(7); break;
    default: RDT_SUM_SHOTS(8); break;
  }
#undef RDT_SUM_SHOTS
  return (int)cudaGetLastError();
}

// The tape's cells that one block of bwd_tape_step reads: the tile, cut to
// the field, and 2 cells around it (where L(s_{m-1}) is taken for the
// tile's sums); never the window's 2U-cell halo, which only the cotangent
// needs. Each thread's share of them, in coalesced order, is worked out
// once a launch (window and field offsets, the same for every slot), so a
// slot's copy is N cp.async a thread and nothing else.
template <class L>
struct TapeCopy {
  static constexpr int N = (L::LY * L::LX + L::THREADS - 1) / L::THREADS;
  int win[N], fld[N], n = 0;
  __device__ TapeCopy(const Cells<L>& m, const int* gyv, const int* gxv,
                      int H, int W) {
    const int ry = (m.ty < H - m.y0 ? m.ty : H - m.y0) + 4;
    const int rx = (m.tx < W - m.x0 ? m.tx : W - m.x0) + 4;
    const int tid = threadIdx.y * L::NTX + threadIdx.x;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int i = tid + r * L::THREADS;
      if (i >= ry * rx) break;
      const int y = m.h - 2 + i / rx, x = m.h - 2 + i % rx;
      win[r] = L::at(y, x);
      fld[r] = gyv[y] * W + gxv[x];
      n = r + 1;
    }
  }
  // This thread's cells of one slot (of this field) into window buffer buf.
  __device__ void load(float* buf, const float* slot) const {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r < n) {
        copy_async(&buf[win[r]], slot + fld[r]);
      }
  }
};

// The tape adjoint's share of the tile's cells for its sums: U steps a
// launch (compile-time) give a TY x TX tile; thread t takes the cells
// t, t + THREADS, ... of the tile in row-major order (K at most), so every
// warp takes its part and a warp's cells lie side by side.
template <class L, int U>
struct TileShare {
  static constexpr int TY = L::LY - 4 * U, TX = L::LX - 4 * U;
  static constexpr int K = (TY * TX + L::THREADS - 1) / L::THREADS;
  static __device__ int row(int tid, int e) { return (tid + e * L::THREADS) / TX; }
  static __device__ int col(int tid, int e) { return (tid + e * L::THREADS) % TX; }
  // Cell e's offset in a window, recomputed where needed.
  static __device__ int at(int tid, int e) {
    return L::at(2 * U + row(tid, e), 2 * U + col(tid, e));
  }
};

// Reversed steps k_hi down to k_hi-n+1 (n <= U) of the taped adjoint, one
// block per (tile, sample*shot), in the adjoint's blocking (BwdL; a 16x48
// tile at U=4): bwd_reverse_step with s_{m-1} and s_{m-2} read from the
// tape instead of rebuilt, and no divide by t2.
//   u_in, v_in: cotangents of s_{m-1}, s_m (m = k_hi + 1; v before the
//     receiver injection); u_out, v_out: those of the group's last step.
//   tape: chunk + 1 slots of `slot` cells, slot i = s_{i-1}; step k reads
//     s_{m-1} and s_{m-2} from slots k+1 and k.
//   pa, p1, p2: this shot's running alpha, t1 and t2 cotangents
//     (B, ns, H, W), added to in step order; ginj: (B, ns, 1, W).
// Each step has two parts between one barrier and the next:
//   the sums, at the tile's cells (TileShare: K cells a thread, every
//     thread): galpha += v*L(s_{m-1}), gt1 += v*s_{m-1}, gt2 -= v*s_{m-2},
//     and on the source row ginj += v*src[k]; the running sums stay in
//     registers for the launch;
//   the cotangent, at every live cell (an MY x MX micro-tile a thread, in
//     registers): v' = u + t1*v + L(alpha*v), u' = -t2*v, the next step's
//     receiver cotangent added to v'; alpha*v' and v' go to the next shared
//     windows (alpha*v for the neighbours' Laplacian, v for the sums).
// The tape is read only at the tile and 2 cells around it: slot k, loaded
// at step k+1 as s_{m-1}, is step k's s_{m-2}, so a group of n steps loads
// n+1 slots, each once, into three buffers used in turn; the next slot's
// copy (cp.async) is issued before a step's arithmetic and waited for at
// its barrier.
//
// It replaces _bwd_kernel (red_diffeq_tpu/ops/stencil.py:271-349, launched
// by _run_bwd at :582), which keeps a whole (b, s) field and U+2 haloed tape
// states in VMEM and carries the cotangents through its grid. At one launch
// per step the per-step traffic (u, v, two tape slots in, u, v out) and the
// launch rate bound it; blocked, one launch per U steps moves u, v, alpha,
// t1, t2 and the per-shot sums once, and the tape's n+1 slots at the tile
// plus 2 cells (1.35x the tile's cells at 16x48). What is left bounds it:
// the window load through L2 and the steps' shared-memory latency at two
// blocks per SM; the sums' share of a step is spread over every warp.
// At U=1 (a field under 8 cells a side) each thread keeps 7 cells' sums;
// one block per SM lets those fit in registers.
template <int U>
__global__ void __launch_bounds__(BwdL::THREADS, U > 1 ? 2 : 1) bwd_tape_step(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    float* __restrict__ u_out, float* __restrict__ v_out,
    const float* __restrict__ tape, float* __restrict__ pa,
    float* __restrict__ p1, float* __restrict__ p2,
    float* __restrict__ ginj, const float* __restrict__ grec,
    const float* __restrict__ alpha, const float* __restrict__ t1,
    const float* __restrict__ t2, const float* __restrict__ src, int k_hi,
    int n, int ns, int H, int W, int isz, int igz, int g0, int ng, int chunk,
    long long slot) {
  using L = BwdL;
  using T = TileShare<L, U>;
  constexpr int MX = L::MX, MY = L::MY, K = T::K;
  extern __shared__ float smem[];
  // Window offsets in smem: alpha*v and v each in turn, the tape buffers in
  // turn (s_{m-1}, s_{m-2}, the next slot's copy), alpha, t1, t2.
  int wc = 0, wn = L::SIZE, vc = 2 * L::SIZE, vn = 3 * L::SIZE;
  int tc = 4 * L::SIZE, tp = 5 * L::SIZE, tq = 6 * L::SIZE;
  constexpr int WA = 7 * L::SIZE, W1 = 8 * L::SIZE, W2 = 9 * L::SIZE;
  Cells<L> m(U);
  const int bs = blockIdx.z;
  const size_t f = (size_t)bs * H * W;
  const size_t cb = (size_t)(bs / ns) * H * W;
  const float* gr = grec + (size_t)bs * chunk * ng;
  const float* tf = tape + f;
  float* ginjr = ginj + (size_t)bs * W;
  int* gyv = reinterpret_cast<int*>(smem + 10 * L::SIZE);
  int* gxv = gyv + L::LY;
  window_index<L>(gyv, gxv, m.y0 - m.h, m.x0 - m.h, H, W);
  zero_pads<L>(smem, 2);
  __syncthreads();
  m.classify(gyv, gxv, H, W, isz, igz, g0, ng);
  const int tid = threadIdx.y * L::NTX + threadIdx.x;
  // This thread's tile cells: which lie in the field and which on the
  // source row; their running sums, read here, written at the end.
  unsigned mine = 0, on_src = 0;
  float qa[K], q1[K], q2[K];
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const int r = T::row(tid, e), x = T::col(tid, e);
    if (r < T::TY && m.y0 + r < H && m.x0 + x < W) {
      mine |= 1u << e;
      on_src |= (unsigned)(gyv[m.h + r] == isz) << e;
      const size_t g = f + (size_t)gyv[m.h + r] * W + gxv[m.h + x];
      qa[e] = pa[g];
      q1[e] = p1[g];
      q2[e] = p2[g];
    }
  }
  // The window, in coalesced order: u and v into the two alpha*v windows
  // (each thread then reads its own cells), alpha, t1, t2; the tape's
  // slots k_hi+1 and k_hi at the tile.
  for (int i = tid; i < L::LY * L::LX; i += L::THREADS) {
    const int y = i / L::LX, x = i % L::LX, c = L::at(y, x);
    const size_t gc = cb + (size_t)gyv[y] * W + gxv[x];
    const size_t g = f + (size_t)gyv[y] * W + gxv[x];
    copy_async(&smem[wn + c], u_in + g);
    copy_async(&smem[wc + c], v_in + g);
    copy_async(&smem[WA + c], alpha + gc);
    copy_async(&smem[W1 + c], t1 + gc);
    copy_async(&smem[W2 + c], t2 + gc);
  }
  const TapeCopy<L> tape_copy(m, gyv, gxv, H, W);
  tape_copy.load(&smem[tc], tf + (size_t)(k_hi + 1) * slot);
  tape_copy.load(&smem[tp], tf + (size_t)k_hi * slot);
  copy_wait();
  __syncthreads();
  float u[MY][MX], v[MY][MX];
#pragma unroll
  for (int j = 0; j < MY; ++j) {
    float a[MX], w[MX];
    load_row(&smem[wn + L::at(m.ly + j, m.lx)], u[j]);
    load_row(&smem[wc + L::at(m.ly + j, m.lx)], v[j]);
    load_row(&smem[WA + L::at(m.ly + j, m.lx)], a);
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      if (m.rec(j, i))
        v[j][i] = v[j][i] + gr[(size_t)k_hi * ng + (m.gx(i) - g0)];
      w[i] = a[i] * v[j][i];
    }
    store_row(&smem[wc + L::at(m.ly + j, m.lx)], w);
    store_row(&smem[vc + L::at(m.ly + j, m.lx)], v[j]);
  }
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    const int k = k_hi - s;
    // Slot k-1, the next step's s_{m-2}, while this step computes.
    if (s + 1 < n) tape_copy.load(&smem[tq], tf + (size_t)(k - 1) * slot);
    {
      // The tile's sums, at this thread's share of its cells.
      const float sk = src[k];
      const float* s1 = &smem[tc];
#pragma unroll
      for (int e = 0; e < K; ++e) {
        if (!(mine >> e & 1u)) continue;
        const int c = T::at(tid, e);
        const float vv = smem[vc + c];
        const float sv = s1[c];
        const float ls =
            kC2 * (((s1[c - L::SX] + s1[c + L::SX]) + s1[c - 1]) + s1[c + 1]) +
            kC3 * (((s1[c - 2 * L::SX] + s1[c + 2 * L::SX]) + s1[c - 2]) +
                   s1[c + 2]);
        qa[e] = qa[e] + vv * ls;
        q1[e] = q1[e] + vv * sv;
        q2[e] = q2[e] - vv * smem[tp + c];
        if (on_src >> e & 1u) {
          const int gx = gxv[m.h + T::col(tid, e)];
          ginjr[gx] = ginjr[gx] + vv * sk;
        }
      }
    }
    if (m.live(2 * (U - n + 1 + s))) {
      {
        float w[MY][MX];
#pragma unroll
        for (int j = 0; j < MY; ++j) {
          float a[MX];
          load_row(&smem[WA + L::at(m.ly + j, m.lx)], a);
#pragma unroll
          for (int i = 0; i < MX; ++i) w[j][i] = a[i] * v[j][i];
        }
        const Edges<L> e(&smem[wc], m.ly, m.lx);
#pragma unroll
        for (int j = 0; j < MY; ++j) {
          float l2, l1, r1, r2, c1[MX], c2[MX];
          load_pair(&smem[wc + L::at(m.ly + j, m.lx - 2)], l2, l1);
          load_pair(&smem[wc + L::at(m.ly + j, m.lx + MX)], r1, r2);
          load_row(&smem[W1 + L::at(m.ly + j, m.lx)], c1);
          load_row(&smem[W2 + L::at(m.ly + j, m.lx)], c2);
          const bool rec_next = s + 1 < n;
#pragma unroll
          for (int i = 0; i < MX; ++i) {
            const float vv = v[j][i];
            float nv = (u[j][i] + c1[i] * vv) +
                       lap_cell<L>(w, e, l2, l1, r1, r2, j, i);
            if (rec_next && m.rec(j, i))
              nv = nv + gr[(size_t)(k - 1) * ng + (m.gx(i) - g0)];
            u[j][i] = -c2[i] * vv;
            v[j][i] = nv;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < MY; ++j) {
        float a[MX], w[MX];
        load_row(&smem[WA + L::at(m.ly + j, m.lx)], a);
#pragma unroll
        for (int i = 0; i < MX; ++i) w[i] = a[i] * v[j][i];
        store_row(&smem[wn + L::at(m.ly + j, m.lx)], w);
        store_row(&smem[vn + L::at(m.ly + j, m.lx)], v[j]);
      }
    }
    copy_wait();
    __syncthreads();
    int t;
    t = tc; tc = tp; tp = tq; tq = t;
    t = wc; wc = wn; wn = t;
    t = vc; vc = vn; vn = t;
  }
  // The sums from registers; u and v to two windows, then the tile leaves
  // in coalesced order.
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if (!(mine >> e & 1u)) continue;
    const int r = T::row(tid, e), x = T::col(tid, e);
    const size_t g = f + (size_t)gyv[m.h + r] * W + gxv[m.h + x];
    pa[g] = qa[e];
    p1[g] = q1[e];
    p2[g] = q2[e];
  }
#pragma unroll
  for (int j = 0; j < MY; ++j) {
    store_row(&smem[wc + L::at(m.ly + j, m.lx)], u[j]);
    store_row(&smem[wn + L::at(m.ly + j, m.lx)], v[j]);
  }
  __syncthreads();
  for (int i = tid; i < L::LY * L::LX; i += L::THREADS) {
    const int y = i / L::LX, x = i % L::LX, c = L::at(y, x);
    if (!tile_cell(m, y, x, H, W)) continue;
    const size_t g = f + (size_t)gyv[y] * W + gxv[x];
    u_out[g] = smem[wc + c];
    v_out[g] = smem[wn + c];
  }
}

// Shared memory of one block of each blocked kernel, in bytes.
constexpr size_t kFwdSmem =
    5 * FwdL::SIZE * sizeof(float) + (FwdL::LY + FwdL::LX) * sizeof(int);
constexpr size_t kBwdSmem =
    (8 * BwdL::SIZE + 3 * BwdL::LY * BwdL::LX) * sizeof(float) +
    (BwdL::LY + BwdL::LX) * sizeof(int);
// The taped adjoint: ten windows (its running sums are in registers).
constexpr size_t kTapeSmem =
    10 * BwdL::SIZE * sizeof(float) + (BwdL::LY + BwdL::LX) * sizeof(int);

// Most steps per launch of each blocked kernel (the two adjoints share
// theirs).
constexpr int kFwdMaxUnroll = 4, kBwdMaxUnroll = 4;

// Whether `unroll` steps a launch suit a blocked kernel of at most `max_u`
// on an H x W field: the two halos of 2U cells fit in its shorter side.
inline bool unroll_fits(int unroll, int max_u, int H, int W) {
  return unroll >= 1 && unroll <= max_u && 4 * unroll <= (H < W ? H : W);
}

// The grid of a blocked kernel with layout L at `unroll` steps a launch:
// the tile is the window less the two halos.
template <class L>
dim3 tile_grid(int unroll, int B, int ns, int H, int W) {
  const int ty = L::LY - 4 * unroll, tx = L::LX - 4 * unroll;
  return dim3((W + tx - 1) / tx, (H + ty - 1) / ty, B * ns);
}

// Shared memory of one tape_step block at `ranks` blocks a field: two
// state buffers of the largest strip and its 4 halo rows, alpha, t1 and t2
// at the strip, the injection row.
inline size_t tape_smem(int ranks, int H, int W) {
  const size_t rmax = strip_rows(ranks, H);
  return (5 * rmax + 9) * W * sizeof(float);
}

// Whether tape_step takes an H x W field in clusters of `ranks` blocks: a
// cluster size it is built for, strips of at least 2 rows (the halo
// depth), a block's shared memory within 227 KB.
inline bool tape_fits(int ranks, int H, int W) {
  if (ranks < 1 || ranks > kTapeMaxRanks || (ranks & (ranks - 1)) != 0)
    return false;
  return H / ranks >= 2 && W >= 1 && tape_smem(ranks, H, W) <= kMaxSmem;
}

// The launch configuration of tape_step: grid (ranks, fields), clusters of
// (ranks, 1, 1); attr must outlive the launch.
inline cudaLaunchConfig_t tape_config(int ranks, int fields, int H, int W,
                                      cudaLaunchAttribute* attr,
                                      cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, fields, 1);
  cfg.blockDim = dim3(kTapeThreads, 1, 1);
  cfg.dynamicSmemBytes = tape_smem(ranks, H, W);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow tape_step its shared memory and a cluster size above 8.
inline cudaError_t tape_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      tape_step, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      tape_step, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Blocks per cluster of the tape replay for an H-row field: the most (16,
// 8, 4, 2, 1) that leave every strip 2 rows or more.
inline int tape_cluster_ranks(int H) {
  int r = kTapeMaxRanks;
  while (r > 1 && H / r < 2) r /= 2;
  return r;
}

// Shared memory of one tape_step_stream block with `planes` resident
// planes at `ranks` blocks a field: two state buffers of the largest strip
// and its 4 halo rows, the planes at the strip, the injection row.
inline size_t stream_smem(int planes, int ranks, int H, int W) {
  const size_t rmax = strip_rows(ranks, H);
  return (2 * (rmax + 4) + planes * rmax + 1) * W * sizeof(float);
}

// Whether tape_step_stream<planes> takes an H x W field in clusters of
// `ranks` blocks: a cluster size and plane count it is built for, strips
// of at least 2 rows, a block's shared memory within 227 KB.
inline bool stream_fits(int planes, int ranks, int H, int W) {
  if (ranks < 1 || ranks > kTapeMaxRanks || (ranks & (ranks - 1)) != 0)
    return false;
  if (planes < 0 || planes > 2 || H < 5 || W < 5) return false;
  return H / ranks >= 2 && stream_smem(planes, ranks, H, W) <= kMaxSmem;
}

using StreamKernel = void (*)(float*, const float*, const float*,
                              const float*, const float*, const float*,
                              const float*, const float*, int, int, int, int,
                              int, int, long long);

inline StreamKernel stream_kernel(int planes) {
  switch (planes) {
    case 0: return tape_step_stream<0>;
    case 1: return tape_step_stream<1>;
    default: return tape_step_stream<2>;
  }
}

// The launch configuration of tape_step_stream: grid (ranks, fields),
// clusters of (ranks, 1, 1); attr must outlive the launch.
inline cudaLaunchConfig_t stream_config(int planes, int ranks, int fields,
                                        int H, int W,
                                        cudaLaunchAttribute* attr,
                                        cudaStream_t st) {
  cudaLaunchConfig_t cfg = tape_config(ranks, fields, H, W, attr, st);
  cfg.dynamicSmemBytes = stream_smem(planes, ranks, H, W);
  return cfg;
}

// Allow tape_step_stream<planes> its shared memory and a cluster size
// above 8.
inline cudaError_t stream_attributes(int planes, size_t smem) {
  const StreamKernel fn = stream_kernel(planes);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// `chunk` forward steps on PyTorch's stream, in groups of `unroll` steps
// (the last group may be shorter), one fwd_step launch per group. p0, p1
// hold s_{-1}, s_0 and are only read; the groups write (x0, x1) and
// (y0, y1) in turn, so the chunk's end states are in (x0, x1) when the
// number of groups is odd and in (y0, y1) when it is even.
// recs: (B, ns, chunk, ng). Returns the first launch error, 0 if none.
extern "C" int rdt_fwd_chunk(const float* p0, const float* p1, float* x0,
                             float* x1, float* y0, float* y1,
                             const float* alpha, const float* t1,
                             const float* t2, const float* inj,
                             const float* src, float* recs, int B, int ns,
                             int H, int W, int isz, int igz, int g0, int ng,
                             int chunk, int unroll, void* stream) {
  if (!unroll_fits(unroll, kFwdMaxUnroll, H, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = kFwdSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_step, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = tile_grid<FwdL>(unroll, B, ns, H, W);
  const dim3 block(FwdL::NTX, FwdL::NTY);
  const float* a0 = p0;
  const float* a1 = p1;
  float* b0 = x0;
  float* b1 = x1;
  for (int k0 = 0; k0 < chunk; k0 += unroll) {
    const int n = chunk - k0 < unroll ? chunk - k0 : unroll;
    fwd_step<<<grid, block, smem, st>>>(a0, a1, b0, b1, alpha, t1, t2, inj,
                                        src, recs, k0, n, unroll, ns,
                                        H, W, isz, igz, g0, ng, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a0 = b0;
    a1 = b1;
    b0 = b0 == x0 ? y0 : x0;
    b1 = b1 == x1 ? y1 : x1;
  }
  return 0;
}

// The tape-free adjoint of one chunk on PyTorch's stream, steps chunk-1
// down to 0 in groups of `unroll` (the last may be shorter), one
// bwd_reverse_step launch per group. u, v (cotangents of s_{chunk-1},
// s_chunk) and s_m, s_m1 (s_chunk, s_{chunk-1}) are only read; the groups
// write set x (x[0..3] = u, v, s_m, s_m1) and set y in turn, so the
// cotangents of the chunk's start states end in x[0], x[1] when the number
// of groups is odd and in y[0], y[1] when it is even. pa, p1, p2
// (B, ns, H, W) and ginj (B, ns, 1, W) accumulate and must be zeroed by the
// caller. Unless galpha is null, one sum_shots launch after the last group
// then adds pa, p1, p2 over shots into galpha, gt1, gt2 (B, 1, H, W).
// Returns the first launch error, 0 if none.
extern "C" int rdt_bwd_reverse_chunk(
    const float* u, const float* v, const float* s_m, const float* s_m1,
    float* const* x, float* const* y, float* pa, float* p1, float* p2,
    float* ginj, float* galpha, float* gt1, float* gt2, const float* grec,
    const float* alpha, const float* t1, const float* t2, const float* inj,
    const float* src, int B, int ns, int H, int W, int isz, int igz, int g0,
    int ng, int chunk, int unroll, void* stream) {
  if (!unroll_fits(unroll, kBwdMaxUnroll, H, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = kBwdSmem;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_reverse_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = tile_grid<BwdL>(unroll, B, ns, H, W);
  const dim3 block(BwdL::NTX, BwdL::NTY);
  const float* in[4] = {u, v, s_m, s_m1};
  float* const* out = x;
  for (int k_hi = chunk - 1; k_hi >= 0; k_hi -= unroll) {
    const int n = k_hi + 1 < unroll ? k_hi + 1 : unroll;
    bwd_reverse_step<<<grid, block, smem, st>>>(
        in[0], in[1], in[2], in[3], out[0], out[1], out[2], out[3], pa, p1,
        p2, ginj, grec, alpha, t1, t2, inj, src, k_hi, n, unroll, ns,
        H, W, isz, igz, g0, ng, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < 4; ++i) in[i] = out[i];
    out = out == x ? y : x;
  }
  return galpha == nullptr ? 0
                           : launch_sum_shots(pa, p1, p2, galpha, gt1, gt2,
                                              B, ns, H * W, st);
}

// The shot sums of the adjoint's per-shot coefficient cotangents on
// PyTorch's stream: pa, p1, p2 (B, ns, hw) into galpha, gt1, gt2 (B, hw).
// Returns the launch error, 0 if none.
extern "C" int rdt_sum_shots(const float* pa, const float* p1,
                             const float* p2, float* galpha, float* gt1,
                             float* gt2, int B, int ns, int hw,
                             void* stream) {
  return launch_sum_shots(pa, p1, p2, galpha, gt1, gt2, B, ns, hw,
                          static_cast<cudaStream_t>(stream));
}

// The blocking of blocked kernel `which` (0 fwd_step, 1 bwd_reverse_step,
// 3 bwd_tape_step) on an H x W field: the most steps per launch U whose two halos of 2U cells
// fit in the field's shorter side, and the tile (the window less the
// halos) that one block then writes. Returns cudaErrorInvalidValue for
// another kernel or a field too small for U = 1, 0 otherwise.
extern "C" int rdt_blocking(int which, int H, int W, int* unroll,
                            int* tile_y, int* tile_x) {
  int max_u, ly, lx;
  switch (which) {
    case 0: max_u = kFwdMaxUnroll; ly = FwdL::LY; lx = FwdL::LX; break;
    case 1:
    case 3: max_u = kBwdMaxUnroll; ly = BwdL::LY; lx = BwdL::LX; break;
    default: return (int)cudaErrorInvalidValue;
  }
  int u = (H < W ? H : W) / 4;
  if (u > max_u) u = max_u;
  if (!unroll_fits(u, max_u, H, W)) return (int)cudaErrorInvalidValue;
  *unroll = u;
  *tile_y = ly - 4 * u;
  *tile_x = lx - 4 * u;
  return 0;
}

// Blocks per cluster of tape_step for an H x W field: the most (16, 8, 4,
// 2, 1) that leave every strip 2 rows or more. Returns
// cudaErrorInvalidValue when the field is beyond tape_step's size limit
// (tape_fits at that cluster size), 0 otherwise.
extern "C" int rdt_tape_ranks(int H, int W, int* ranks) {
  const int r = tape_cluster_ranks(H);
  if (!tape_fits(r, H, W)) return (int)cudaErrorInvalidValue;
  *ranks = r;
  return 0;
}

// The cluster of tape_step_stream for an H x W field: in *ranks its blocks
// (as tape_step's, rdt_tape_ranks) and in *planes the coefficient planes
// kept in shared memory, the most of 2, 1, 0 that fit (stream_fits).
// Returns cudaErrorInvalidValue when none fits (the field is past the
// kernel's size limit, or wider than a block's threads), 0 otherwise.
extern "C" int rdt_tape_stream_plan(int H, int W, int* ranks, int* planes) {
  const int r = tape_cluster_ranks(H);
  for (int np = 2; np >= 0; --np)
    if (stream_fits(np, r, H, W)) {
      *ranks = r;
      *planes = np;
      return 0;
    }
  return (int)cudaErrorInvalidValue;
}

// Registers per thread, local (spill) bytes per thread and resident blocks
// per SM of kernel `which` (0 fwd_step, 1 bwd_reverse_step, 2 tape_step,
// 3 bwd_tape_step, 4 sum_shots, 5 tape_step_global, 6 tape_step_stream)
// at its launch configuration; the blocked
// kernels with their shared memory, bwd_tape_step as launched for U=4 and
// sum_shots for 5 shots (the headline's). tape_step and tape_step_stream
// (the instantiation rdt_tape_stream_plan picks) as launched for an H x W
// field (H and W are read for these alone), with its shared memory and
// cluster size (*ranks), and in *clusters the clusters that can be
// resident on the card at once (0 for the other kernels). Returns a CUDA
// error, 0 if none.
extern "C" int rdt_kernel_info(int which, int H, int W, int* regs,
                               int* local_bytes, int* blocks_per_sm,
                               int* ranks, int* clusters) {
  const void* fn;
  int threads;
  size_t smem = 0;
  cudaError_t err;
  *ranks = 0;
  *clusters = 0;
  switch (which) {
    case 0: fn = (const void*)fwd_step; threads = FwdL::THREADS;
            smem = kFwdSmem; break;
    case 1: fn = (const void*)bwd_reverse_step; threads = BwdL::THREADS;
            smem = kBwdSmem; break;
    case 2: {
      threads = kTapeThreads;
      if (rdt_tape_ranks(H, W, ranks) != 0) return (int)cudaErrorInvalidValue;
      fn = (const void*)tape_step;
      smem = tape_smem(*ranks, H, W);
      err = tape_attributes(smem);
      if (err != cudaSuccess) return (int)err;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          tape_config(*ranks, 1, H, W, &attr, nullptr);
      err = cudaOccupancyMaxActiveClusters(clusters, tape_step, &cfg);
      if (err != cudaSuccess) return (int)err;
      break;
    }
    case 3: fn = (const void*)bwd_tape_step<4>; threads = BwdL::THREADS;
            smem = kTapeSmem; break;
    case 4: fn = (const void*)sum_shots<5>; threads = kSumThreads; break;
    case 5: fn = (const void*)tape_step_global;
            threads = kTapeGlobalX * kTapeGlobalY; break;
    case 6: {
      threads = kTapeThreads;
      int planes;
      if (rdt_tape_stream_plan(H, W, ranks, &planes) != 0)
        return (int)cudaErrorInvalidValue;
      const StreamKernel kernel = stream_kernel(planes);
      fn = (const void*)kernel;
      smem = stream_smem(planes, *ranks, H, W);
      err = stream_attributes(planes, smem);
      if (err != cudaSuccess) return (int)err;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          stream_config(planes, *ranks, 1, H, W, &attr, nullptr);
      err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      break;
    }
    default: return (int)cudaErrorInvalidValue;
  }
  if (smem > 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, threads, smem);
}

// The tape of one chunk on PyTorch's stream, in one tape_step launch:
// chunk + 1 states of B*ns*H*W cells, slot i = s_{i-1} for i = 0 .. chunk,
// the slots the taped adjoint reads. p0, p1 (s_{-1}, s_0) are only read and
// go to slots 0 and 1. `ranks` blocks a field (rdt_tape_ranks). Returns
// the launch error, 0 if none.
extern "C" int rdt_tape_chunk(float* tape, const float* p0, const float* p1,
                              const float* alpha, const float* t1,
                              const float* t2, const float* inj,
                              const float* src, int B, int ns, int H, int W,
                              int isz, int chunk, int ranks, void* stream) {
  if (chunk < 1 || !tape_fits(ranks, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = tape_attributes(tape_smem(ranks, H, W));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tape_config(ranks, B * ns, H, W, &attr, st);
  const long long slot = (long long)B * ns * H * W;
  err = cudaLaunchKernelEx(&cfg, tape_step, tape, p0, p1, alpha, t1, t2, inj,
                           src, chunk, ns, H, W, isz, ranks, slot);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tape of one chunk past tape_step's size limit on PyTorch's stream,
// in one tape_step_stream<planes> launch: the slots of rdt_tape_chunk, at
// `ranks` blocks a field and `planes` resident coefficient planes
// (rdt_tape_stream_plan). Returns the launch error, 0 if none.
extern "C" int rdt_tape_chunk_stream(float* tape, const float* p0,
                                     const float* p1, const float* alpha,
                                     const float* t1, const float* t2,
                                     const float* inj, const float* src,
                                     int B, int ns, int H, int W, int isz,
                                     int chunk, int ranks, int planes,
                                     void* stream) {
  if (chunk < 1 || !stream_fits(planes, ranks, H, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      stream_attributes(planes, stream_smem(planes, ranks, H, W));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      stream_config(planes, ranks, B * ns, H, W, &attr, st);
  const long long slot = (long long)B * ns * H * W;
  err = cudaLaunchKernelEx(&cfg, stream_kernel(planes), tape, p0, p1, alpha,
                           t1, t2, inj, src, chunk, ns, H, W, isz, ranks,
                           slot);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tape of one chunk past tape_step_stream's size limit on PyTorch's
// stream: the slots of rdt_tape_chunk, written by chunk - 1 tape_step_global
// launches (one for a chunk of one step, which only copies the carry).
// Returns the first launch error, 0 if none.
extern "C" int rdt_tape_chunk_global(float* tape, const float* p0,
                                     const float* p1, const float* alpha,
                                     const float* t1, const float* t2,
                                     const float* inj, const float* src,
                                     int B, int ns, int H, int W, int isz,
                                     int chunk, void* stream) {
  if (chunk < 1 || H < 5 || W < 5) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long slot = (long long)B * ns * H * W;
  const dim3 grid((W + kTapeGlobalX - 1) / kTapeGlobalX,
                  (H + kTapeGlobalY - 1) / kTapeGlobalY, B * ns);
  const dim3 block(kTapeGlobalX, kTapeGlobalY);
  const int launches = chunk > 1 ? chunk - 1 : 1;
  for (int k = 0; k < launches; ++k) {
    tape_step_global<<<grid, block, 0, st>>>(
        tape, p0, p1, alpha, t1, t2, inj, src, k, chunk, ns, H, W, isz,
        slot);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The taped adjoint of one chunk on PyTorch's stream, steps chunk-1 down to
// 0 in groups of `unroll` (the last may be shorter), one bwd_tape_step
// launch per group, reading the tape written by rdt_tape_chunk (its chunk
// + 1 slots, 0 .. chunk). u, v (cotangents of s_{chunk-1}, s_chunk) are only read; the
// groups write (x0, x1) and (y0, y1) in turn, so the cotangents of the
// chunk's start states end in (x0, x1) when the number of groups is odd and
// in (y0, y1) when it is even. pa, p1, p2 (B, ns, H, W) and ginj
// (B, ns, 1, W) accumulate and must be zeroed by the caller. Unless galpha
// is null, one sum_shots launch after the last group then adds pa, p1, p2
// over shots into galpha, gt1, gt2 (B, 1, H, W). Returns the first launch
// error, 0 if none.
extern "C" int rdt_bwd_tape_chunk(
    const float* u, const float* v, const float* tape, float* x0, float* x1,
    float* y0, float* y1, float* pa, float* p1, float* p2, float* ginj,
    float* galpha, float* gt1, float* gt2, const float* grec,
    const float* alpha, const float* t1, const float* t2, const float* src,
    int B, int ns, int H, int W, int isz, int igz, int g0, int ng, int chunk,
    int unroll, void* stream) {
  if (!unroll_fits(unroll, kBwdMaxUnroll, H, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = kTapeSmem;
  const void* kernel;
  switch (unroll) {
    case 1: kernel = (const void*)bwd_tape_step<1>; break;
    case 2: kernel = (const void*)bwd_tape_step<2>; break;
    case 3: kernel = (const void*)bwd_tape_step<3>; break;
    default: kernel = (const void*)bwd_tape_step<4>; break;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = tile_grid<BwdL>(unroll, B, ns, H, W);
  const dim3 block(BwdL::NTX, BwdL::NTY);
  const long long slot = (long long)B * ns * H * W;
  const float* a0 = u;
  const float* a1 = v;
  float* b0 = x0;
  float* b1 = x1;
  for (int k_hi = chunk - 1; k_hi >= 0; k_hi -= unroll) {
    const int n = k_hi + 1 < unroll ? k_hi + 1 : unroll;
#define RDT_BWD_TAPE_STEP(U)                                                \
  bwd_tape_step<U><<<grid, block, smem, st>>>(                              \
      a0, a1, b0, b1, tape, pa, p1, p2, ginj, grec, alpha, t1, t2, src,     \
      k_hi, n, ns, H, W, isz, igz, g0, ng, chunk, slot)
    switch (unroll) {
      case 1: RDT_BWD_TAPE_STEP(1); break;
      case 2: RDT_BWD_TAPE_STEP(2); break;
      case 3: RDT_BWD_TAPE_STEP(3); break;
      default: RDT_BWD_TAPE_STEP(4); break;
    }
#undef RDT_BWD_TAPE_STEP
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a0 = b0;
    a1 = b1;
    b0 = b0 == x0 ? y0 : x0;
    b1 = b1 == x1 ? y1 : x1;
  }
  return galpha == nullptr ? 0
                           : launch_sum_shots(pa, p1, p2, galpha, gt1, gt2,
                                              B, ns, H * W, st);
}
