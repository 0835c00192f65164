// The stencil-layout probe for Hopper (sm_90a): one bare damped-wave
// recursion with four layouts of its x-stencil, with a plain C interface
// loaded through ctypes (red_diffeq_tpu_torch/ops/layout_probe.py).
//
// probe_roll replaces _roll_kernel (tools/kernel_layout_probe.py:89,
// launched at :219), probe_mxu<false> (probe_mxu_x) replaces _mxu_x_kernel
// (:106, at :226), probe_mxu<true> (probe_mxu_xy) replaces _mxu_xy_kernel
// (:129, at :234), probe_halo replaces _halo_kernel (:158, at :240).
// probe_roll and probe_halo are one instantiation each of probe_resident;
// fields past its size limit take probe_roll_global and probe_halo_global.
//
// Recursion, per field of H x W cells (nprog independent fields):
//   p = t1*p1 - t2*p0 + alpha*L(p1)
// with L the circular 4th-order Laplacian without its centre term (C2 =
// 4/3 on the +-1 neighbours, C3 = -1/12 on the +-2 ones, both axes) and
// alpha, t1, t2 one H x W plane shared by every field. No source, no
// receivers: the result is the newest state after nt steps.
//
// Bound on this card (H100 SXM: 67 TFLOP/s fp32, 3.35 TB/s). The function
// is the same for all four: 14 fp32 operations a cell and step (the
// banded circulant counts as its 4 non-zeros a column), so at the probe's
// workload (20 fields of 310x310, nt=1000) 26.9 GFLOP, 0.40 ms; its bytes
// (the two start states, the three planes and the result, 24 MB) take
// 7 us, so operations bound it. The TPU kernels keep one field in VMEM
// for all nt steps. A 310x310 field (384 KB) is above a block's 227 KB of
// shared memory, so roll and halo keep each field in the shared memory of
// a thread-block cluster (probe_resident, below): one launch a call, the
// states on chip for all nt steps, what bounds them the per-step work of
// a block and the cluster barrier. The mxu kernels take one step a
// launch, nt launches a call, the states in device memory between the
// launches (at the workload both states and the planes, 16.5 MB, stay in
// the 50 MB L2); their dense products, 2W (or 2W + 2H) operations a cell
// where the stencil takes 14, run on the tensor cores in split TF32
// (below) and are bound by that work.
//
// Each step of roll and mxu writes the new state over the older of the
// two it reads (each cell reads only its own cell of that state), so two
// buffers serve a whole call; the caller's states are only read. Build
// with -fmad=false: every multiply and add rounds alone, in the JAX
// kernels' grouping, so roll and halo (both routes) equal their plain
// PyTorch versions bit for bit; the products' sums are the tensor cores'
// (split TF32, below).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr float kC2 = (float)(4.0 / 3.0);
constexpr float kC3 = (float)(-1.0 / 12.0);

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// The update at one cell, in the grouping (t1*p1 - t2*p0) + alpha*lap.
__device__ __forceinline__ float update(float t1, float p1, float t2,
                                        float p0, float alpha, float lap) {
  return (t1 * p1 - t2 * p0) + alpha * lap;
}

// ---------------------------------------------------------------------------
// probe_roll_global (_roll_kernel, for fields past probe_resident's size
// limit): both stencils as 8 wrapped neighbour reads, one step a launch. A
// block owns a 32x32-cell tile of one field and loads it with a wrapped
// halo of 2 cells a side (36x36) into shared memory; each of its 32x8
// threads then updates 4 cells of a column. The tile's reads from L2 are
// 1.27x the field's, its shared-memory reads 8 a cell. Bound: each
// launch's traffic (both states and the planes, about 27 MB a step at
// 20 fields of 310x310, all in L2) and the launch itself, not its 14
// operations a cell.
// L = kC2*(((p[y-1] + p[y+1]) + p[x-1]) + p[x+1])
//   + kC3*(((p[y-2] + p[y+2]) + p[x-2]) + p[x+2]), as _lap_roll.
// ---------------------------------------------------------------------------

constexpr int kRollT = 32, kRollRows = 8;
constexpr int kRollS = kRollT + 4;   // the window's side, halo included
constexpr size_t kRollSmem = sizeof(float) * kRollS * kRollS;

// Grid (ceil(W/32), ceil(H/32), nprog), block (32, 8).
__global__ void __launch_bounds__(kRollT * kRollRows)
    probe_roll_global(const float* p0, const float* p1, float* out,
               const float* __restrict__ alpha, const float* __restrict__ t1,
               const float* __restrict__ t2, int H, int W) {
  extern __shared__ float smem[];
  const int x0 = blockIdx.x * kRollT, y0 = blockIdx.y * kRollT;
  const size_t f = (size_t)blockIdx.z * H * W;
  const float* s = p1 + f;
  for (int i = threadIdx.y * kRollT + threadIdx.x; i < kRollS * kRollS;
       i += kRollT * kRollRows) {
    const int ly = i / kRollS, lx = i % kRollS;
    smem[i] = s[(size_t)wrap(y0 + ly - 2, H) * W + wrap(x0 + lx - 2, W)];
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int r = 0; r < kRollT / kRollRows; ++r) {
    const int ly = threadIdx.y + kRollRows * r, y = y0 + ly;
    if (y >= H) return;
    const float* c = smem + (ly + 2) * kRollS + threadIdx.x + 2;
    const float lap =
        kC2 * (((c[-kRollS] + c[kRollS]) + c[-1]) + c[1]) +
        kC3 * (((c[-2 * kRollS] + c[2 * kRollS]) + c[-2]) + c[2]);
    const int cell = y * W + x;
    out[f + cell] = update(t1[cell], c[0], t2[cell], p0[f + cell],
                           alpha[cell], lap);
  }
}

// ---------------------------------------------------------------------------
// probe_mxu<XY> (_mxu_x_kernel, XY false; _mxu_xy_kernel, XY true): the x
// stencil as the dense product p @ D with D = band_circulant(W), and with
// XY the y stencil as E @ p with E = band_circulant(H), on the tensor cores
// at fp32 accuracy (Precision.HIGHEST on the TPU's MXU). Without XY the y
// stencil is 4 wrapped neighbour reads, as _lap_y_roll. One step a launch.
//   lap = lap_y + (p @ D)          (XY false, as _mxu_x_kernel)
//   lap = (E @ p) + (p @ D)        (XY true, as _mxu_xy_kernel)
//
// Split TF32 products (mma.sync m16n8k8 TF32, fp32 accumulators). Both
// operands, the state p and D or E, are split here, as their fragments are
// read from shared memory, into 3 TF32 parts (split_parts): the first
// rounded to 8 significant bits, the next cut to 8, the last what is left,
// so they hold an fp32 value exactly. Each 8-deep step of the depth adds
// the part products (i, j) with i + j <= 2, 6 of them, smallest first:
// (2, 0), (1, 1), (0, 2), (1, 0), (0, 1) into one accumulator, the main
// (0, 0) into another; the result is their sum.
//
// Why not 3xTF32 (2 parts of 11 bits; lo*hi, hi*lo, hi*hi): an mma.sync
// does not round its sum to nearest, it truncates, a bias toward zero of
// up to an ulp at every mma that adds terms to a sum they do not fit, the
// same sign every step. On an H100 (tools/torch_probe_breakdown.py), after
// 1000 steps, 3xTF32 ended 1.3e-4 (mxu_x) and 2.6e-4 (mxu_xy) max-rel from
// torch.matmul, 3 parts of 11 bits 1.1e-4 and 2.2e-4, against the JAX
// tool's gate of 1e-4; these parts 9e-6 and 1e-5. With 8-bit parts a main
// product has 16 significant bits, so the mma's sum of a column's four
// in-band products is exact unless they lie more than 2^8 apart; the
// smaller products go to their own accumulator, where a truncation costs
// 2^-8 of what it would cost the main one; and the two meet in an fp32
// add, which rounds to nearest.
//
// A block owns a 64x64-cell tile of one field, each of its 4 warps 32x32
// cells (2 x 4 fragments of 16x8). The depth goes through shared memory in
// slabs of kMxuK, every tile of a slab copied by 16-byte cp.async.cg in a
// ring of kStages stages, so that the next slab loads while the current
// one multiplies; what lies past the ragged edge (310 is no multiple of 8
// or 32) is zero-filled by the copy's source size. A [64 rows][kMxuK deep]
// tile has rows of kMxuK + 4 floats, a [kMxuK deep][64 columns] tile rows
// of 72, so that a warp's fragment reads (rows g, columns t; or rows t,
// columns g) fall in 32 different banks. Every matrix the kernel reads,
// the states and D, has rows of round4(W) floats (E round4(H)) and a
// 16-byte aligned start, so every copy is aligned; the columns past W are
// never read. The products go through shared memory (E @ p there while
// p @ D runs), so that the epilogue reads the planes and states and writes
// the new state a row of 64 cells at a time.
//
// The product stays dense, as on the TPU: every slab of D and E is
// multiplied, zeros and all (skipping D's zero blocks would make it a
// stencil again, which is probe_roll's question). The design's floor is
// its TF32 work, kPasses passes of 2W operations a cell (2(W + H) with
// XY): at the probe's workload (20 fields of 310x310, nt=1000) 1.19 GFLOP
// a pass and step, 14.4 ms a call at 495 TFLOP/s with 6 passes, 28.9 ms
// with XY, beside the function's bound of 0.40 ms. On an H100 the
// mma.sync alone take about 22 ms a product (the 'mma only' variant of
// tools/torch_probe_breakdown.py), 2/3 of that rate; the splits, the
// staging and the epilogue add what they do not hide.
// ---------------------------------------------------------------------------

constexpr int kMxuT = 64, kMxuK = 32, kStages = 2, kMxuThreads = 128;
constexpr int kSA = kMxuK + 4;   // row stride of a [64][kMxuK] tile
constexpr int kSB = kMxuT + 8;   // row stride of a [kMxuK][64] tile
constexpr int kTile =
    kMxuT * kSA > kMxuK * kSB ? kMxuT * kSA : kMxuK * kSB;
// A stage: the constant's tile, then the state's.
constexpr int kStage = 2 * kTile;
// The stages, then the tile's products for the epilogue (64 rows of kSB).
constexpr size_t kMxuSmem = sizeof(float) * (kStages * kStage + kMxuT * kSB);

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Parts of each operand, and part products a step of the depth.
constexpr int kParts = 3, kPasses = 6;

// Part of the state (state) or of the constant in pass n: the part
// products (i of the state, j of the constant) with i + j <= 2, the
// smallest first; the last, the main one (0, 0), has its own accumulator.
__host__ __device__ constexpr int pass_part(int n, bool state) {
  constexpr int kPass[kPasses][2] = {{2, 0}, {1, 1}, {0, 2},
                                     {1, 0}, {0, 1}, {0, 0}};
  return kPass[n][state ? 0 : 1];
}

// The warp-level pieces, the only code that differs in the host
// emulation (tests/cuda_host/cuda_host.h).
#ifdef CUDA_HOST_EMULATION
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  host::mma_m16n8k8_tf32(c, a, b);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  host::cp_async(dst, src, 16, src_bytes);
}
__device__ __forceinline__ void cp_async_commit() { host::cp_async_commit(); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { host::cp_async_wait(N); }
#else
// c += a @ b on one warp's m16n8k8 TF32 fragments (PTX ISA layout).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 16 bytes from global src to shared dst, src_bytes of them read and the
// rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
#endif

// x as 3 TF32 parts, largest first, summing to x exactly: the first x
// rounded to 8 significant bits (to nearest, ties away from zero, so that
// the remainder's sign varies with x), the second the remainder cut to 8
// bits, the third what is left (8 bits at most). Every remainder is exact
// in fp32. Finite x.
__device__ __forceinline__ void split_parts(float x,
                                            unsigned (&part)[kParts]) {
  // Half of the 16 dropped bits, and the 8 kept.
  constexpr unsigned kHalf = 1u << 15, kCut = ~0xffffu;
  part[0] = (__float_as_uint(x) + kHalf) & kCut;
  x = x - __uint_as_float(part[0]);
  part[1] = __float_as_uint(x) & kCut;
  part[2] = __float_as_uint(x - __uint_as_float(part[1]));
}

// Copy rows r0 .. r0 + R - 1, columns c0 .. c0 + C - 1 of the rows x cols
// matrix m (row stride ld, a multiple of 4) into the tile t (row stride
// S), 4 floats a copy, zero-filling what lies outside the matrix.
template <int R, int C, int S>
__device__ __forceinline__ void stage_tile(float* t, const float* m, int ld,
                                           int rows, int cols, int r0,
                                           int c0) {
  constexpr int kChunks = R * C / 4;
  static_assert(kChunks % kMxuThreads == 0, "whole copies a thread");
#pragma unroll
  for (int q = 0; q < kChunks / kMxuThreads; ++q) {
    const int j = threadIdx.x + q * kMxuThreads;
    const int r = j / (C / 4), c = 4 * (j % (C / 4));
    const int gr = r0 + r, gc = c0 + c;
    const int n = gr < rows && gc < cols ? (cols - gc < 4 ? cols - gc : 4)
                                         : 0;
    cp_async16(t + r * S + c, n ? m + (size_t)gr * ld + gc : m, 4 * n);
  }
}

// Slab `slab` of A (M x K) and B (K x N) for the block's tile at (row0,
// col0) into stage st: the constant c (row stride ldc) into tile 0, the
// state s (row stride lds) into tile 1. kConstA: A is the constant and B
// the state; else A is the state and B the constant.
template <bool kConstA>
__device__ __forceinline__ void load_slab(float* st, const float* s, int lds,
                                          const float* c, int ldc, int M,
                                          int N, int K, int row0, int col0,
                                          int slab) {
  const int k0 = slab * kMxuK;
  if (kConstA) {
    stage_tile<kMxuT, kMxuK, kSA>(st, c, ldc, M, K, row0, k0);
    stage_tile<kMxuK, kMxuT, kSB>(st + kTile, s, lds, K, N, k0, col0);
  } else {
    stage_tile<kMxuK, kMxuT, kSB>(st, c, ldc, K, N, k0, col0);
    stage_tile<kMxuT, kMxuK, kSA>(st + kTile, s, lds, M, K, row0, k0);
  }
}

// The staged slab's part of the warp's 32x32 product (rows 32 wm, columns
// 32 wn of the tile), 8 deep at a time: the main pass (0, 0) into main,
// the others into corr. Tile 0 of the stage holds the constant.
template <bool kConstA>
__device__ __forceinline__ void mma_slab(const float* st, int wm, int wn,
                                         int lane, float (&main)[2][4][4],
                                         float (&corr)[2][4][4]) {
  const float* sa = st + (kConstA ? 0 : kTile);
  const float* sb = st + (kConstA ? kTile : 0);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < kMxuK; k8 += 8) {
    unsigned a[kParts][2][4], b[kParts][4][2], part[kParts];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // a0..a3 at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
      const int r0 = 32 * wm + 16 * i + g, r1 = r0 + 8;
      const int at[4] = {r0 * kSA + k8 + t, r1 * kSA + k8 + t,
                         r0 * kSA + k8 + t + 4, r1 * kSA + k8 + t + 4};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_parts(sa[at[r]], part);
#pragma unroll
        for (int q = 0; q < kParts; ++q) a[q][i][r] = part[q];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // b0, b1 at (t, g), (t + 4, g).
      const int c = 32 * wn + 8 * j + g;
      const int at[2] = {(k8 + t) * kSB + c, (k8 + t + 4) * kSB + c};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        split_parts(sb[at[r]], part);
#pragma unroll
        for (int q = 0; q < kParts; ++q) b[q][j][r] = part[q];
      }
    }
#pragma unroll
    for (int n = 0; n < kPasses; ++n) {
      const int ap = pass_part(n, !kConstA), bp = pass_part(n, kConstA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(n < kPasses - 1 ? corr[i][j] : main[i][j], a[ap][i],
                   b[bp][j]);
    }
  }
}

// acc = A @ B (A is M x K, B is K x N) for the block's 64x64 tile at
// (row0, col0), as main + corr: the state s (row stride lds) is B when
// kConstA and A otherwise, the constant c (row stride ldc) the other.
// The ring: slab n lands in stage n % kStages; at slab n every thread
// waits for its own copies of it, and the barrier after that both
// publishes the slab and shows that every warp is done with slab n - 1,
// whose stage the copies of slab n + kStages - 1 then take.
template <bool kConstA>
__device__ void product_tile(const float* s, int lds, const float* c,
                             int ldc, int M, int N, int K, int row0, int col0,
                             float* smem, float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nslab = (K + kMxuK - 1) / kMxuK;
  float main[2][4][4] = {}, corr[2][4][4] = {};
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < nslab)
      load_slab<kConstA>(smem + n * kStage, s, lds, c, ldc, M, N, K, row0,
                         col0, n);
    cp_async_commit();
  }
  for (int n = 0; n < nslab; ++n) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = n + kStages - 1;
    if (next < nslab)
      load_slab<kConstA>(smem + (next % kStages) * kStage, s, lds, c, ldc,
                         M, N, K, row0, col0, next);
    cp_async_commit();
    mma_slab<kConstA>(smem + (n % kStages) * kStage, warp >> 1, warp & 1,
                      lane, main, corr);
  }
  __syncthreads();   // every warp is done with the stages
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = main[i][j][r] + corr[i][j][r];
}

// The warp's 32x32 fragments of the tile into `tile` (rows of kSB
// floats), added to what it holds with kAdd: fragment (i, j) holds c0, c1
// at (g, 2t), (g, 2t + 1) and c2, c3 at (g + 8, 2t), (g + 8, 2t + 1).
template <bool kAdd>
__device__ __forceinline__ void put_fragments(float* tile,
                                              const float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * (warp >> 1) + 16 * i + g + 8 * h;
        const int c = 32 * (warp & 1) + 8 * j + 2 * t;
        float2* at = reinterpret_cast<float2*>(tile + r * kSB + c);
        float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        if (kAdd) {
          const float2 w = *at;
          v = make_float2(w.x + v.x, w.y + v.y);
        }
        *at = v;
      }
}

// i + d wrapped into [0, n), for |d| <= n.
__device__ __forceinline__ int wrap_near(int i, int n) {
  return i < 0 ? i + n : i >= n ? i - n : i;
}

// Grid (ceil(W/64), ceil(H/64), nprog), block 128. The states (p0, p1,
// out) and D have rows of round4(W) floats, E of round4(H).
template <bool XY>
__global__ void __launch_bounds__(kMxuThreads)
    probe_mxu(const float* p0, const float* p1, float* out,
              const float* __restrict__ alpha, const float* __restrict__ t1,
              const float* __restrict__ t2, const float* __restrict__ d,
              const float* __restrict__ e, int H, int W) {
  extern __shared__ float smem[];
  const int ld = round4(W);
  const int row0 = blockIdx.y * kMxuT, col0 = blockIdx.x * kMxuT;
  const size_t f = (size_t)blockIdx.z * H * ld;
  const float* s = p1 + f;
  // The tile's products in shared memory past the stages, rows of kSB
  // floats: with XY E @ p first, then (E @ p) + (p @ D) over it; each
  // thread reads back only what it wrote.
  float* lap_tile = smem + kStages * kStage;
  float acc[2][4][4];
  if (XY) {
    product_tile<true>(s, ld, e, round4(H), H, W, H, row0, col0, smem, acc);
    put_fragments<false>(lap_tile, acc);
  }
  product_tile<false>(s, ld, d, ld, H, W, W, row0, col0, smem, acc);
  put_fragments<XY>(lap_tile, acc);
  __syncthreads();
  // The update, 2 rows of 64 cells at a time, 4 rows a thread in flight:
  // every read of a row first, then the writes (out may be p0).
  const int x = col0 + (threadIdx.x & 63);
  if (x >= W) return;
  constexpr int kRows = 4;
#pragma unroll 1
  for (int r0 = threadIdx.x >> 6; r0 < kMxuT; r0 += 2 * kRows) {
    float lap[kRows], c1[kRows], c0[kRows], a[kRows], u[kRows], v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = r0 + 2 * k, y = row0 + r;
      if (y >= H) break;
      lap[k] = lap_tile[r * kSB + (threadIdx.x & 63)];
      if (!XY) {
        const float* col = s + x;
        lap[k] = (kC2 * (col[(size_t)wrap_near(y - 1, H) * ld] +
                         col[(size_t)wrap_near(y + 1, H) * ld]) +
                  kC3 * (col[(size_t)wrap_near(y - 2, H) * ld] +
                         col[(size_t)wrap_near(y + 2, H) * ld])) +
                 lap[k];
      }
      const int cell = y * W + x;
      const size_t at = (size_t)y * ld + x;
      c1[k] = s[at];
      c0[k] = p0[f + at];
      a[k] = alpha[cell];
      u[k] = t1[cell];
      v[k] = t2[cell];
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int y = row0 + r0 + 2 * k;
      if (y >= H) break;
      out[f + (size_t)y * ld + x] = update(u[k], c1[k], v[k], c0[k], a[k],
                                           lap[k]);
    }
  }
}

// Dynamic shared memory above 48 KB for both product kernels.
cudaError_t mxu_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      probe_mxu<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMxuSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(probe_mxu<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kMxuSmem);
}

// ---------------------------------------------------------------------------
// probe_halo_global (_halo_kernel, for fields past probe_resident's size
// limit): each field's state kept as H x (W + 4) in device memory, columns
// 2 .. W+1 the cells, columns 0, 1 copies of cells W-2, W-1 and columns
// W+2, W+3 copies of cells 0, 1, so the x neighbours are plain offsets
// with no modular index; y neighbours wrap, as _lap_y_roll. Two states in
// turn: a step reads p1 from one and writes the new state, halo copies
// included, over p0 in the other (each cell reads only its own cell of p0
// and no step reads p0's halo columns, so the rewrite races with nothing).
// One cell a thread, one step a launch; every read goes to L1/L2, as the
// TPU kernel's unaligned slices go to VMEM. Bound: as probe_roll_global,
// each launch's L2 traffic and the launch itself.
//   lap = (kC2*(p[y-1] + p[y+1]) + kC3*(p[y-2] + p[y+2]))
//       + (kC2*(p[x-1] + p[x+1]) + kC3*(p[x-2] + p[x+2]))
// ---------------------------------------------------------------------------

constexpr int kHaloX = 32, kHaloY = 8;

// Grid (ceil(W/32), ceil(H/8), nprog), block (32, 8).
__global__ void __launch_bounds__(kHaloX * kHaloY)
    probe_halo_global(const float* src, float* dst, const float* __restrict__ alpha,
               const float* __restrict__ t1, const float* __restrict__ t2,
               int H, int W) {
  const int x = blockIdx.x * kHaloX + threadIdx.x;
  const int y = blockIdx.y * kHaloY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int S = W + 4;
  const size_t f = (size_t)blockIdx.z * H * S;
  const float* col = src + f + x + 2;
  const float* c = col + (size_t)y * S;
  const float lap_y = kC2 * (col[(size_t)wrap(y - 1, H) * S] +
                             col[(size_t)wrap(y + 1, H) * S]) +
                      kC3 * (col[(size_t)wrap(y - 2, H) * S] +
                             col[(size_t)wrap(y + 2, H) * S]);
  const float xsum = kC2 * (c[-1] + c[1]) + kC3 * (c[-2] + c[2]);
  const int cell = y * W + x;
  float* o = dst + f + (size_t)y * S + x + 2;
  const float p = update(t1[cell], c[0], t2[cell], o[0], alpha[cell],
                         lap_y + xsum);
  o[0] = p;
  if (x < 2) o[W] = p;        // the right halo, columns W+2, W+3
  if (x >= W - 2) o[-W] = p;  // the left halo, columns 0, 1
}

// ---------------------------------------------------------------------------
// probe_resident<false> (probe_roll, _roll_kernel) and probe_resident<true>
// (probe_halo, _halo_kernel): all nt steps in one launch, every field in
// shared memory for the whole call, as the TPU kernels keep it in VMEM
// scratch across their grid's step axis. A thread-block cluster of `ranks`
// blocks (16 for a field of 32 rows or more, a non-portable size) holds
// `per` fields; block `rank` owns rows [rank*H/ranks, (rank+1)*H/ranks) of
// each (a strip of at least 2 rows, the halo depth) at every column. For
// each field it keeps two buffers of its strip with 2 halo rows above and
// below, s_k and s_{k-1}, used in turn: a step computes s_{k+1} over
// s_{k-1} in place (each cell read and written by one thread) and writes
// the strip's first and last 2 rows straight into the halo rows of the
// ranks above and below (rank 0 wraps to rank ranks-1) through distributed
// shared memory. One cluster barrier a step (arrive releases those writes,
// wait acquires the neighbours') orders the block's own rows and its halo
// rows before the next step. A block writes into a neighbour's buffer only
// the halo rows that the neighbour reads after the next barrier, and the
// neighbour last read them before the barrier of the step before. The last
// step writes no halo rows, so a block may leave after it; the newest
// state goes to device memory once, in the last step. This is tape_step's
// scheme (stencil.cu) without its tape.
//
// The two layouts differ only in x, the probe's question. roll keeps rows
// of W floats and reads its x neighbours at wrapped columns, which a thread
// works out once a call (it owns fixed columns). halo keeps rows of W + 4
// floats, cell x at column x + 2: each step the owners of cells 0, 1, W-2
// and W-1 also write them into the 2 halo columns a side of their row, as
// _halo_kernel does, so the x neighbours are plain offsets.
//
// A thread takes one column of one band of the strip's rows (as many bands
// as keep the block's threads busy, each band whole warps, neighbouring
// threads on neighbouring columns) and walks down it field by field with
// the column's s_k at rows y-2 .. y+1 in registers, so a cell reads 6
// shared values (yp2, the 4 x neighbours, its own s_{k-1}). The band's
// rows are a constant of the code that walks it (step_band<NB>, chosen
// once a field), so its cells run straight, with no guard. Its cells'
// alpha, t1 and t2, at most kResBand rows of one column, are loaded once
// into registers and serve every field of the cluster: the three planes
// are never copied per field, and shared memory holds the states alone.
// halo's halo columns are stored from the new values' registers by the
// threads that own them; the rows pushed to the neighbours are read back
// after the band. No global load is left inside a step: a cell that
// waited for one would hold the whole cluster at the barrier.
//
// Sizing (the probe's workload, 20 fields of 310x310): a strip of 19-20
// rows, 3 bands of 6-7 rows on 930 of 1024 threads, per = 3 fields in
// 3 x 2 x 24 rows x 310 floats = 179 KB a block; 7 clusters of 16 blocks
// hold the 20 fields in one wave. A step of a block is then 18600 cell
// updates and one cluster barrier. What bounds it (H100, PERF.md):
// the cell updates' instructions (about 30 a cell; a guard and a branch a
// cell cost 40% more, hence the constant NB), at 64 registers a thread,
// where the allocation decides 10% either way; then the cluster barrier
// (its release compiles to a GPU-wide memory barrier) and the halo-row
// pushes, about 0.6 us a step each. Limits (resident_fits): W <= 1024
// (one column a thread), bands of at most kResBand rows, a block's shared
// memory within 227 KB; larger fields take the *_global kernels.
// lap (roll) = kC2*(((p[y-1] + p[y+1]) + p[x-1]) + p[x+1])
//            + kC3*(((p[y-2] + p[y+2]) + p[x-2]) + p[x+2]), as _lap_roll;
// lap (halo) = (kC2*(p[y-1] + p[y+1]) + kC3*(p[y-2] + p[y+2]))
//            + (kC2*(p[x-1] + p[x+1]) + kC3*(p[x-2] + p[x+2])).
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

// The cluster calls: this block's rank in its cluster, the address in
// another rank's shared memory at the offset of p in this block's, an
// offset from it, a store there, and the cluster barrier in its two
// halves: arrive (releasing this thread's
// writes, local and remote, to the cluster) and wait (until every thread
// of the cluster has arrived; acquiring their writes).
__device__ __forceinline__ int cluster_rank() {
  return (int)cg::this_cluster().block_rank();
}

// A float in another rank's shared memory: on the card a 32-bit
// shared::cluster address (mapa), stored to with st.shared::cluster, so
// that it costs one register and no generic-address translation; in the
// host build a pointer.
#ifdef CUDA_HOST_EMULATION
using cluster_addr = float*;
__device__ __forceinline__ cluster_addr cluster_map(float* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}
__device__ __forceinline__ cluster_addr cluster_at(cluster_addr a, int i) {
  return a + i;
}
__device__ __forceinline__ void cluster_store(cluster_addr a, int i,
                                              float v) {
  a[i] = v;
}
#else
using cluster_addr = unsigned;
__device__ __forceinline__ cluster_addr cluster_map(float* p, int rank) {
  unsigned a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a)
      : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}
// The float i floats past a.
__device__ __forceinline__ cluster_addr cluster_at(cluster_addr a, int i) {
  return a + 4 * i;
}
// Ordered before the cluster barrier's arrive, whose asm clobbers memory.
__device__ __forceinline__ void cluster_store(cluster_addr a, int i,
                                              float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a + 4 * i), "f"(v));
}
#endif

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

constexpr int kResThreads = 1024;
constexpr int kResBand = 8;         // most rows of a band
constexpr int kResMaxRanks = 16;    // a non-portable cluster size
constexpr size_t kMaxSmem = 232448;   // 227 KB a block

// First row of rank r's strip.
__host__ __device__ __forceinline__ int strip_start(int r, int ranks,
                                                    int H) {
  return (int)((long long)r * H / ranks);
}

// Rows of the largest strip.
__host__ __device__ __forceinline__ int strip_rows(int ranks, int H) {
  return (H + ranks - 1) / ranks;
}

// A band's threads: W rounded up to whole warps, so that the threads of a
// warp share one band (and one count of rows).
__host__ __device__ __forceinline__ int band_threads(int W) {
  return (W + 31) & ~31;
}

// Bands of a strip of `rows` rows at width W (W <= kResThreads).
__host__ __device__ __forceinline__ int strip_bands(int rows, int W) {
  const int b = kResThreads / band_threads(W);
  return b < rows ? b : rows;
}

// One step at the NB cells of a thread's band of one field: s_{k+1} over
// s_{k-1} at each, with the column's s_k at rows y-2 .. y+1 rolled down in
// registers. c and o point at the band's first cell in s_k and s_{k-1};
// dm1, dm2, dp1, dp2 are roll's wrapped x neighbours as offsets from the
// cell (halo reads plain offsets). NB is a constant, so the cells run
// straight, with no guard, and the coefficients stay in registers. With
// `columns` (halo's owners of cells 0, 1, W-2, W-1) each new value also
// goes, from its register, to its halo column, d floats away.
template <bool kHalo, int NB>
__device__ __forceinline__ void step_band(
    const float* __restrict__ c, float* __restrict__ o, int S, int dm1,
    int dm2, int dp1, int dp2, const float (&ca)[kResBand],
    const float (&cu)[kResBand], const float (&cv)[kResBand], bool columns,
    int d) {
  float ym2 = c[-2 * S], ym1 = c[-S], cc = c[0], yp1 = c[S];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float* r = c + j * S;
    const float yp2 = r[2 * S];
    float lap;
    if (kHalo)
      lap = (kC2 * (ym1 + yp1) + kC3 * (ym2 + yp2)) +
            (kC2 * (r[-1] + r[1]) + kC3 * (r[-2] + r[2]));
    else
      lap = kC2 * (((ym1 + yp1) + r[dm1]) + r[dp1]) +
            kC3 * (((ym2 + yp2) + r[dm2]) + r[dp2]);
    const float p = update(cu[j], cc, cv[j], o[j * S], ca[j], lap);
    o[j * S] = p;
    if (kHalo && columns) o[j * S + d] = p;
    ym2 = ym1;
    ym1 = cc;
    cc = yp1;
    yp1 = yp2;
  }
}

// Grid (ranks, ceil(nprog/per)), clusters of (ranks, 1, 1), kResThreads a
// block. Shared memory: per fields x two buffers of (largest strip + 4
// halo rows) rows of S floats. out (nprog x H x W) gets the newest state.
template <bool kHalo>
__global__ void __launch_bounds__(kResThreads, 1)
    probe_resident(const float* __restrict__ p0, const float* __restrict__ p1,
                   float* __restrict__ out, const float* __restrict__ alpha,
                   const float* __restrict__ t1, const float* __restrict__ t2,
                   int nprog, int H, int W, int nt, int ranks, int per) {
  extern __shared__ float smem[];
  const int rank = cluster_rank();
  const int tid = threadIdx.x;
  const int S = kHalo ? W + 4 : W;           // a row of a buffer
  const int r0 = strip_start(rank, ranks, H);
  const int rows = strip_start(rank + 1, ranks, H) - r0;
  const int bsz = (strip_rows(ranks, H) + 4) * S;   // one buffer
  const int own = 2 * S + (kHalo ? 2 : 0);   // cell (0, 0), after 2 halo rows
  const int f0 = blockIdx.y * per;
  const int nf = nprog - f0 < per ? nprog - f0 : per;
  // Where this strip's first 2 rows go in the rank above (its bottom halo
  // rows) and its last 2 rows in the rank below (its top halo rows), at
  // field 0's buffer 0, as offsets from the strip's cell (0, 0) there.
  const int up = (rank + ranks - 1) % ranks, dn = (rank + 1) % ranks;
  const int up_rows = strip_start(up + 1, ranks, H) - strip_start(up, ranks, H);
  const cluster_addr to_up = cluster_at(cluster_map(smem, up),
                                        own + up_rows * S);
  const cluster_addr to_dn = cluster_at(cluster_map(smem, dn),
                                        own - rows * S);
  // This thread's share of a step, worked out once: column x of one of
  // `bands` bands of the strip's rows, rows ya .. ya + nb - 1; its rows
  // among the strip's first 2 (ya .. top - 1) and last 2 (bot .. ya + nb
  // - 1), which go to the neighbours; whether it owns one of halo's halo
  // columns, d floats from its cells.
  const int bands = strip_bands(rows, W);
  const int band = tid / band_threads(W), x = tid % band_threads(W);
  const bool busy = band < bands && x < W;
  const int ya = busy ? band * rows / bands : 0;
  const int nb = busy ? (band + 1) * rows / bands - ya : 0;
  const int top = ya + nb < 2 ? ya + nb : 2;
  const int bot = ya > rows - 2 ? ya : rows - 2;
  const bool columns = kHalo && (x < 2 || x >= W - 2);
  const int d = x < 2 ? W : -W;
  // roll's wrapped x neighbours, as offsets from the cell.
  const int dm1 = x == 0 ? W - 1 : -1, dp1 = x == W - 1 ? 1 - W : 1;
  const int dm2 = x < 2 ? W - 2 : -2, dp2 = x >= W - 2 ? 2 - W : 2;
  // The cells' coefficients, in registers for the whole call.
  float ca[kResBand], cu[kResBand], cv[kResBand];
#pragma unroll
  for (int j = 0; j < kResBand; ++j) {
    if (j < nb) {
      const size_t g = (size_t)(r0 + ya + j) * W + x;
      ca[j] = alpha[g];
      cu[j] = t1[g];
      cv[j] = t2[g];
    }
  }
  // s_0 at the strip and its halo rows of buffer 0 and s_{-1} at the strip
  // of buffer 1, every column of a row (halo's halo columns included).
  for (int f = 0; f < nf; ++f) {
    const size_t g = (size_t)(f0 + f) * H * W;
    float* const b0 = smem + 2 * f * bsz;
    for (int i = tid; i < (rows + 4) * S; i += kResThreads) {
      const int y = i / S - 2, c = i % S;
      const int xc = kHalo ? (c < 2 ? c + W - 2 : c >= W + 2 ? c - W - 2
                                                            : c - 2)
                           : c;
      b0[i] = p1[g + (size_t)wrap(r0 + y, H) * W + xc];
      if (y >= 0 && y < rows) b0[bsz + i] = p0[g + (size_t)(r0 + y) * W + xc];
    }
  }
  // Every block of the cluster is running (before any write to another's
  // shared memory) and has loaded its strips.
  cluster_arrive();
  cluster_wait();
  const int at = ya * S + x;    // the band's first cell, from cell (0, 0)
  int cur = 0, nxt = bsz;       // offsets of the buffers of s_k and s_{k-1}
  for (int k = 0; k < nt; ++k) {
    for (int f = 0; nb > 0 && f < nf; ++f) {
      // s_k is only read, and s_{k-1} only at a thread's own cells.
      const int fb = 2 * f * bsz;
      const float* c = smem + fb + cur + own + at;
      float* const o = smem + fb + nxt + own + at;
      switch (nb) {
#define RDT_STEP_BAND(NB)                                                   \
  case NB:                                                                  \
    step_band<kHalo, NB>(c, o, S, dm1, dm2, dp1, dp2, ca, cu, cv, columns, \
                         d);                                                \
    break
        RDT_STEP_BAND(1); RDT_STEP_BAND(2); RDT_STEP_BAND(3);
        RDT_STEP_BAND(4); RDT_STEP_BAND(5); RDT_STEP_BAND(6);
        RDT_STEP_BAND(7); RDT_STEP_BAND(8);
#undef RDT_STEP_BAND
      }
      // The band's rows among the strip's first and last 2 into the
      // neighbours' halo rows, which the next step reads; after the last
      // step, the newest state to device memory. Each cell is read back by
      // the thread that wrote it.
      if (k + 1 < nt) {
        const cluster_addr up = cluster_at(to_up, fb + nxt + at);
        const cluster_addr dn = cluster_at(to_dn, fb + nxt + at);
        for (int j = 0; ya + j < top; ++j) cluster_store(up, j * S, o[j * S]);
        for (int j = bot - ya; j < nb; ++j)
          cluster_store(dn, j * S, o[j * S]);
      } else {
        float* const g = out + (size_t)(f0 + f) * H * W +
                         (size_t)(r0 + ya) * W + x;
        for (int j = 0; j < nb; ++j) g[j * W] = o[j * S];
      }
    }
    if (k + 1 < nt) {
      cluster_arrive();
      cluster_wait();
    }
    const int t = cur; cur = nxt; nxt = t;
  }
}

// Shared memory of one probe_resident block: `per` fields, two buffers
// each of the largest strip and its 4 halo rows.
inline size_t resident_smem(bool halo, int per, int ranks, int H, int W) {
  return (size_t)per * 2 * (strip_rows(ranks, H) + 4) * (halo ? W + 4 : W) *
         sizeof(float);
}

// Blocks per cluster for an H-row field: the most (16, 8, 4, 2, 1) that
// leave every strip 2 rows or more.
inline int resident_ranks(int H) {
  int r = kResMaxRanks;
  while (r > 1 && H / r < 2) r /= 2;
  return r;
}

// Whether probe_resident takes H x W fields at `ranks` blocks and `per`
// fields a cluster: a cluster size it is built for, strips of at least 2
// rows, one column a thread, bands of at most kResBand rows, a block's
// shared memory within 227 KB.
inline bool resident_fits(bool halo, int per, int ranks, int H, int W) {
  if (ranks < 1 || ranks > kResMaxRanks || (ranks & (ranks - 1)) != 0)
    return false;
  if (per < 1 || H < 5 || W < 5 || W > kResThreads || H / ranks < 2)
    return false;
  const int rmax = strip_rows(ranks, H), bands = strip_bands(rmax, W);
  return (rmax + bands - 1) / bands <= kResBand &&
         resident_smem(halo, per, ranks, H, W) <= kMaxSmem;
}

// The launch configuration of probe_resident: grid (ranks, clusters),
// clusters of (ranks, 1, 1); attr must outlive the launch.
inline cudaLaunchConfig_t resident_config(bool halo, int nprog, int H, int W,
                                          int ranks, int per,
                                          cudaLaunchAttribute* attr,
                                          cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (nprog + per - 1) / per, 1);
  cfg.blockDim = dim3(kResThreads, 1, 1);
  cfg.dynamicSmemBytes = resident_smem(halo, per, ranks, H, W);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow probe_resident<halo> its shared memory and a cluster size above 8.
inline cudaError_t resident_attributes(bool halo, size_t smem) {
  void (*fn)(const float*, const float*, float*, const float*, const float*,
             const float*, int, int, int, int, int, int) =
      halo ? probe_resident<true> : probe_resident<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

bool probe_fits(int nprog, int H, int W, int nt) {
  return nt >= 1 && H >= 5 && W >= 5 && nprog >= 1 && nprog <= 65535;
}

}  // namespace

// nt steps of probe_resident<halo != 0> (probe_halo, else probe_roll) on
// PyTorch's stream, in one launch, from the states p0, p1 (nprog x H x W,
// only read) into out (the newest state, nprog x H x W), at `ranks` blocks
// a cluster and `per` fields a cluster (rdt_probe_plan). Returns the
// launch error, 0 if none.
extern "C" int rdt_probe_resident(int halo, const float* p0, const float* p1,
                                  float* out, const float* alpha,
                                  const float* t1, const float* t2, int nprog,
                                  int H, int W, int nt, int ranks, int per,
                                  void* stream) {
  if (!probe_fits(nprog, H, W, nt) || !resident_fits(halo, per, ranks, H, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = resident_smem(halo, per, ranks, H, W);
  cudaError_t err = resident_attributes(halo, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      resident_config(halo, nprog, H, W, ranks, per, &attr, st);
  err = halo ? cudaLaunchKernelEx(&cfg, probe_resident<true>, p0, p1, out,
                                  alpha, t1, t2, nprog, H, W, nt, ranks, per)
             : cudaLaunchKernelEx(&cfg, probe_resident<false>, p0, p1, out,
                                  alpha, t1, t2, nprog, H, W, nt, ranks, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster of probe_resident<halo != 0> for nprog fields of H x W: in
// *ranks the blocks a field (resident_ranks) and in *per the fields a
// cluster, the fewest that put every field in one wave of the clusters
// the card holds at once (cudaOccupancyMaxActiveClusters at the most
// fields that fit), at most that many; the most that fit when the card
// reports no count. *ranks = *per = 0 for a field past the size limit
// (resident_fits), which the *_global kernels take. Returns a CUDA error,
// 0 if none.
extern "C" int rdt_probe_plan(int halo, int nprog, int H, int W, int* ranks,
                              int* per) {
  *ranks = 0;
  *per = 0;
  if (nprog < 1 || H < 5 || W < 5) return (int)cudaErrorInvalidValue;
  const int r = resident_ranks(H);
  if (!resident_fits(halo, 1, r, H, W)) return 0;
  long long most = (long long)(kMaxSmem / resident_smem(halo, 1, r, H, W));
  if (most > nprog) most = nprog;
  const int fit = (int)most;
  cudaError_t err = resident_attributes(halo, resident_smem(halo, fit, r, H,
                                                            W));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      resident_config(halo, fit, H, W, r, fit, &attr, nullptr);
  int clusters = 0;
  err = halo ? cudaOccupancyMaxActiveClusters(&clusters, probe_resident<true>,
                                              &cfg)
             : cudaOccupancyMaxActiveClusters(&clusters,
                                              probe_resident<false>, &cfg);
  if (err != cudaSuccess) return (int)err;
  int p = fit;
  if (clusters > 0) {
    p = (nprog + clusters - 1) / clusters;
    if (p > fit) p = fit;
  }
  *ranks = r;
  *per = p;
  return 0;
}

// nt steps of probe_roll_global on PyTorch's stream, one launch a step,
// from the states p0, p1 (nprog x H x W, only read). Step n writes x when n
// is even and y when it is odd, so the newest state ends in x when nt is
// odd and in y when it is even. Returns the first launch error, 0 if none.
extern "C" int rdt_probe_roll_global(const float* p0, const float* p1,
                                     float* x, float* y, const float* alpha,
                                     const float* t1, const float* t2,
                                     int nprog, int H, int W, int nt,
                                     void* stream) {
  if (!probe_fits(nprog, H, W, nt)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kRollT - 1) / kRollT, (H + kRollT - 1) / kRollT,
                  nprog);
  const dim3 block(kRollT, kRollRows);
  const float* a0 = p0;
  const float* a1 = p1;
  for (int n = 0; n < nt; ++n) {
    float* o = n % 2 ? y : x;
    probe_roll_global<<<grid, block, kRollSmem, st>>>(a0, a1, o, alpha, t1,
                                                      t2, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a0 = a1;
    a1 = o;
  }
  return 0;
}

// nt steps of probe_mxu<xy != 0> on PyTorch's stream, one launch a step,
// with d = band_circulant(W) (rows of round4(W) floats) and e =
// band_circulant(H) (rows of round4(H); read only with xy). The states p0,
// p1 and x, y as for rdt_probe_roll_global, but with rows of round4(W) floats.
// Every pointer but those to the planes must be 16-byte aligned. Returns
// the first launch error, 0 if none.
extern "C" int rdt_probe_mxu(int xy, const float* p0, const float* p1,
                             float* x, float* y, const float* alpha,
                             const float* t1, const float* t2, const float* d,
                             const float* e, int nprog, int H, int W, int nt,
                             void* stream) {
  if (!probe_fits(nprog, H, W, nt)) return (int)cudaErrorInvalidValue;
  for (const void* q : {(const void*)p0, (const void*)p1, (const void*)x,
                        (const void*)y, (const void*)d, (const void*)e})
    if (reinterpret_cast<size_t>(q) % 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = mxu_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kMxuT - 1) / kMxuT, (H + kMxuT - 1) / kMxuT, nprog);
  const float* a0 = p0;
  const float* a1 = p1;
  for (int n = 0; n < nt; ++n) {
    float* o = n % 2 ? y : x;
    if (xy)
      probe_mxu<true><<<grid, kMxuThreads, kMxuSmem, st>>>(
          a0, a1, o, alpha, t1, t2, d, e, H, W);
    else
      probe_mxu<false><<<grid, kMxuThreads, kMxuSmem, st>>>(
          a0, a1, o, alpha, t1, t2, d, e, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a0 = a1;
    a1 = o;
  }
  return 0;
}

// nt steps of probe_halo_global on PyTorch's stream, one launch a step,
// on the two haloed states s0 (p0) and s1 (p1), nprog x H x (W + 4) each,
// halo columns filled: step u reads state (u + 1) % 2 and writes state
// u % 2, so the newest ends in s0 when nt is odd and in s1 when it is
// even. Returns the first launch error, 0 if none.
extern "C" int rdt_probe_halo_global(float* s0, float* s1, const float* alpha,
                                     const float* t1, const float* t2,
                                     int nprog, int H, int W, int nt,
                                     void* stream) {
  if (!probe_fits(nprog, H, W, nt)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kHaloX - 1) / kHaloX, (H + kHaloY - 1) / kHaloY,
                  nprog);
  const dim3 block(kHaloX, kHaloY);
  for (int u = 0; u < nt; ++u) {
    probe_halo_global<<<grid, block, 0, st>>>(
        u % 2 ? s0 : s1, u % 2 ? s1 : s0, alpha, t1, t2, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Registers per thread, local (spill) bytes per thread and resident blocks
// per SM of the one-launch-a-step probe kernel `which` (0
// probe_roll_global, 1 probe_mxu<false>, 2 probe_mxu<true>, 3
// probe_halo_global) at its launch configuration. Returns the first CUDA
// error, 0 if none.
extern "C" int rdt_probe_info(int which, int* regs, int* local_bytes,
                              int* blocks_per_sm) {
  const void* fn;
  int threads;
  size_t smem = 0;
  switch (which) {
    case 0: fn = (const void*)probe_roll_global;
            threads = kRollT * kRollRows; smem = kRollSmem; break;
    case 1: fn = (const void*)probe_mxu<false>; threads = kMxuThreads;
            smem = kMxuSmem; break;
    case 2: fn = (const void*)probe_mxu<true>; threads = kMxuThreads;
            smem = kMxuSmem; break;
    case 3: fn = (const void*)probe_halo_global;
            threads = kHaloX * kHaloY; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = mxu_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, threads, smem);
}

// The same for probe_resident<halo != 0> as launched for nprog fields of
// H x W (rdt_probe_plan), with in *ranks and *per its cluster and in
// *clusters the clusters that can be resident on the card at once.
// Returns cudaErrorInvalidValue for a field past its size limit, else a
// CUDA error, 0 if none.
extern "C" int rdt_probe_resident_info(int halo, int nprog, int H, int W,
                                       int* regs, int* local_bytes,
                                       int* blocks_per_sm, int* ranks,
                                       int* per, int* clusters) {
  cudaError_t err = (cudaError_t)rdt_probe_plan(halo, nprog, H, W, ranks,
                                                per);
  if (err != cudaSuccess) return (int)err;
  if (*ranks == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = resident_smem(halo, *per, *ranks, H, W);
  err = resident_attributes(halo, smem);
  if (err != cudaSuccess) return (int)err;
  const void* fn = halo ? (const void*)probe_resident<true>
                        : (const void*)probe_resident<false>;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      resident_config(halo, nprog, H, W, *ranks, *per, &attr, nullptr);
  err = halo ? cudaOccupancyMaxActiveClusters(clusters, probe_resident<true>,
                                              &cfg)
             : cudaOccupancyMaxActiveClusters(clusters,
                                              probe_resident<false>, &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kResThreads, smem);
}
