// The stencil-layout probe for Hopper (sm_90a): one bare damped-wave
// recursion with four layouts of its x-stencil, with a plain C interface
// loaded through ctypes (red_diffeq_tpu_torch/ops/layout_probe.py).
//
// probe_roll replaces _roll_kernel (tools/kernel_layout_probe.py:89,
// launched at :219), probe_mxu<false> (probe_mxu_x) replaces _mxu_x_kernel
// (:106, at :226), probe_mxu<true> (probe_mxu_xy) replaces _mxu_xy_kernel
// (:129, at :234), probe_halo replaces _halo_kernel (:158, at :240).
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
// for all nt steps; a 310x310 field (384 KB) is above a block's 227 KB of
// shared memory, so these kernels take one step a launch over all fields,
// nt launches a call, the states in device memory between the launches
// (at the workload both states and the planes, 16.5 MB, stay in the 50 MB
// L2). What bounds roll and halo is not their arithmetic but each
// launch's reads of both states through L2 and the launches' own cost;
// the products of the mxu kernels, 2W (or 2W + 2H) operations a cell
// where the stencil takes 14, are bound by their fp32 work on the CUDA
// cores. Simple kernels that are right: steps per launch (temporal
// blocking) and tensor-core products are later work.
//
// Each step of roll and mxu writes the new state over the older of the
// two it reads (each cell reads only its own cell of that state), so two
// buffers serve a whole call; the launcher's first two steps write into
// fresh buffers so that the caller's states are only read. Build with
// -fmad=false: every multiply and add rounds alone, in the JAX kernels'
// grouping, so roll and halo equal their plain PyTorch versions bit for
// bit; the products sum over k in order, one rounding a term.

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
// probe_roll (_roll_kernel): both stencils as 8 wrapped neighbour reads,
// one step a launch. A block owns a 32x32-cell tile of one field and loads
// it with a wrapped halo of 2 cells a side (36x36) into shared memory; each
// of its 32x8 threads then updates 4 cells of a column. The tile's reads
// from L2 are 1.27x the field's, its shared-memory reads 8 a cell. Bound:
// each launch's traffic (both states and the planes, about 27 MB a step at
// the workload, all in L2) and the launch itself, not its 14 operations a
// cell; steps per launch would cut both.
// L = kC2*(((p[y-1] + p[y+1]) + p[x-1]) + p[x+1])
//   + kC3*(((p[y-2] + p[y+2]) + p[x-2]) + p[x+2]), as _lap_roll.
// ---------------------------------------------------------------------------

constexpr int kRollT = 32, kRollRows = 8;
constexpr int kRollS = kRollT + 4;   // the window's side, halo included
constexpr size_t kRollSmem = sizeof(float) * kRollS * kRollS;

// Grid (ceil(W/32), ceil(H/32), nprog), block (32, 8).
__global__ void __launch_bounds__(kRollT * kRollRows)
    probe_roll(const float* p0, const float* p1, float* out,
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
// XY the y stencil as E @ p with E = band_circulant(H), in fp32 on the CUDA
// cores (Precision.HIGHEST on the TPU: fp32-accurate). Without XY the y
// stencil is 4 wrapped neighbour reads, as _lap_y_roll. One step a launch:
// a block owns a 64x64-cell tile of one field; its 16x16 threads each keep
// 4x4 cells (rows ty + 16r, columns tx + 16c) of the product in registers
// and walk the depth in stages of 16, each stage of both operands staged
// in shared memory (A as [k][row], padded a column against bank
// conflicts; B as [k][column]). Every thread adds its terms k = 0, 1, ...
// in order, one rounding a multiply and one an add. The dense product
// does 2W operations a cell (620 at W=310) where the stencil needs 4, and
// it reads each operand from shared memory once a multiply-add: the CUDA
// cores' fp32 work bounds it. Tensor-core products (3xTF32) are the
// redesign.
//   lap = lap_y + (p @ D)          (XY false, as _mxu_x_kernel)
//   lap = (E @ p) + (p @ D)        (XY true, as _mxu_xy_kernel)
// ---------------------------------------------------------------------------

constexpr int kMxuT = 64, kMxuK = 16, kMxuThreads = 16 * 16;
constexpr int kMxuSA = kMxuT + 1;    // A stage row stride, padded
constexpr size_t kMxuSmem = sizeof(float) * kMxuK * (kMxuSA + kMxuT);

// acc[r][c] += sum over k = 0 .. K-1, in order, of
// A[row0 + ty + 16r][k] * B[k][col0 + tx + 16c] (A is M x K with row
// stride lda, B is K x N with row stride ldb; cells outside read as 0).
__device__ void product_tile(const float* A, int lda, int M, const float* B,
                             int ldb, int N, int K, int row0, int col0,
                             float* sa, float* sb, float (&acc)[4][4]) {
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * 16 + tx;
  for (int k0 = 0; k0 < K; k0 += kMxuK) {
    for (int i = t; i < kMxuT * kMxuK; i += kMxuThreads) {
      const int r = i / kMxuK, k = i % kMxuK;
      const int gr = row0 + r, gk = k0 + k;
      sa[k * kMxuSA + r] = gr < M && gk < K ? A[(size_t)gr * lda + gk] : 0.f;
    }
    for (int i = t; i < kMxuK * kMxuT; i += kMxuThreads) {
      const int k = i / kMxuT, c = i % kMxuT;
      const int gk = k0 + k, gc = col0 + c;
      sb[k * kMxuT + c] = gk < K && gc < N ? B[(size_t)gk * ldb + gc] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kMxuK; ++k) {
      float a[4], b[4];
      for (int r = 0; r < 4; ++r) a[r] = sa[k * kMxuSA + ty + 16 * r];
      for (int c = 0; c < 4; ++c) b[c] = sb[k * kMxuT + tx + 16 * c];
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) acc[r][c] = acc[r][c] + a[r] * b[c];
    }
    __syncthreads();
  }
}

// Grid (ceil(W/64), ceil(H/64), nprog), block (16, 16).
template <bool XY>
__global__ void __launch_bounds__(kMxuThreads)
    probe_mxu(const float* p0, const float* p1, float* out,
              const float* __restrict__ alpha, const float* __restrict__ t1,
              const float* __restrict__ t2, const float* __restrict__ d,
              const float* __restrict__ e, int H, int W) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = smem + kMxuK * kMxuSA;
  const int row0 = blockIdx.y * kMxuT, col0 = blockIdx.x * kMxuT;
  const size_t f = (size_t)blockIdx.z * H * W;
  const float* s = p1 + f;
  float ey[4][4] = {};   // E @ p (XY), then the y stencil
  float dx[4][4] = {};   // p @ D
  if (XY) product_tile(e, H, H, s, W, W, H, row0, col0, sa, sb, ey);
  product_tile(s, W, H, d, W, W, W, row0, col0, sa, sb, dx);
  for (int r = 0; r < 4; ++r) {
    const int y = row0 + threadIdx.y + 16 * r;
    if (y >= H) break;
    for (int c = 0; c < 4; ++c) {
      const int x = col0 + threadIdx.x + 16 * c;
      if (x >= W) break;
      if (!XY) {
        const float* col = s + x;
        ey[r][c] = kC2 * (col[(size_t)wrap(y - 1, H) * W] +
                          col[(size_t)wrap(y + 1, H) * W]) +
                   kC3 * (col[(size_t)wrap(y - 2, H) * W] +
                          col[(size_t)wrap(y + 2, H) * W]);
      }
      const int cell = y * W + x;
      out[f + cell] = update(t1[cell], s[cell], t2[cell], p0[f + cell],
                             alpha[cell], ey[r][c] + dx[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// probe_halo (_halo_kernel): each field's state kept as H x (W + 4) in
// device memory, columns 2 .. W+1 the cells, columns 0, 1 copies of cells
// W-2, W-1 and columns W+2, W+3 copies of cells 0, 1, so the x neighbours
// are plain offsets with no modular index; y neighbours wrap, as
// _lap_y_roll. Two states in turn: a step reads p1 from one and writes the
// new state, halo copies included, over p0 in the other (each cell reads
// only its own cell of p0 and no step reads p0's halo columns, so the
// rewrite races with nothing). One cell a thread, one step a launch; every
// read goes to L1/L2, as the TPU kernel's unaligned slices go to VMEM.
// Bound: as probe_roll, each launch's L2 traffic and the launch itself.
//   lap = (kC2*(p[y-1] + p[y+1]) + kC3*(p[y-2] + p[y+2]))
//       + (kC2*(p[x-1] + p[x+1]) + kC3*(p[x-2] + p[x+2]))
// ---------------------------------------------------------------------------

constexpr int kHaloX = 32, kHaloY = 8;

// Grid (ceil(W/32), ceil(H/8), nprog), block (32, 8).
__global__ void __launch_bounds__(kHaloX * kHaloY)
    probe_halo(const float* src, float* dst, const float* __restrict__ alpha,
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

bool probe_fits(int nprog, int H, int W, int nt) {
  return nt >= 1 && H >= 5 && W >= 5 && nprog >= 1 && nprog <= 65535;
}

}  // namespace

// nt steps of probe_roll on PyTorch's stream, one launch a step, from the
// states p0, p1 (nprog x H x W, only read). Step n writes x when n is even
// and y when it is odd, so the newest state ends in x when nt is odd and
// in y when it is even. Returns the first launch error, 0 if none.
extern "C" int rdt_probe_roll(const float* p0, const float* p1, float* x,
                              float* y, const float* alpha, const float* t1,
                              const float* t2, int nprog, int H, int W,
                              int nt, void* stream) {
  if (!probe_fits(nprog, H, W, nt)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kRollT - 1) / kRollT, (H + kRollT - 1) / kRollT,
                  nprog);
  const dim3 block(kRollT, kRollRows);
  const float* a0 = p0;
  const float* a1 = p1;
  for (int n = 0; n < nt; ++n) {
    float* o = n % 2 ? y : x;
    probe_roll<<<grid, block, kRollSmem, st>>>(a0, a1, o, alpha, t1, t2, H,
                                               W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a0 = a1;
    a1 = o;
  }
  return 0;
}

// nt steps of probe_mxu<xy != 0> on PyTorch's stream, one launch a step,
// with d = band_circulant(W) and e = band_circulant(H) (read only with xy);
// the states and x, y as for rdt_probe_roll. Returns the first launch
// error, 0 if none.
extern "C" int rdt_probe_mxu(int xy, const float* p0, const float* p1,
                             float* x, float* y, const float* alpha,
                             const float* t1, const float* t2, const float* d,
                             const float* e, int nprog, int H, int W, int nt,
                             void* stream) {
  if (!probe_fits(nprog, H, W, nt)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kMxuT - 1) / kMxuT, (H + kMxuT - 1) / kMxuT, nprog);
  const dim3 block(16, 16);
  const float* a0 = p0;
  const float* a1 = p1;
  for (int n = 0; n < nt; ++n) {
    float* o = n % 2 ? y : x;
    if (xy)
      probe_mxu<true><<<grid, block, kMxuSmem, st>>>(a0, a1, o, alpha, t1,
                                                     t2, d, e, H, W);
    else
      probe_mxu<false><<<grid, block, kMxuSmem, st>>>(a0, a1, o, alpha, t1,
                                                      t2, d, e, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a0 = a1;
    a1 = o;
  }
  return 0;
}

// nt steps of probe_halo on PyTorch's stream, one launch a step, on the
// two haloed states s0 (p0) and s1 (p1), nprog x H x (W + 4) each, halo
// columns filled: step u reads state (u + 1) % 2 and writes state u % 2,
// so the newest ends in s0 when nt is odd and in s1 when it is even.
// Returns the first launch error, 0 if none.
extern "C" int rdt_probe_halo(float* s0, float* s1, const float* alpha,
                              const float* t1, const float* t2, int nprog,
                              int H, int W, int nt, void* stream) {
  if (!probe_fits(nprog, H, W, nt)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kHaloX - 1) / kHaloX, (H + kHaloY - 1) / kHaloY,
                  nprog);
  const dim3 block(kHaloX, kHaloY);
  for (int u = 0; u < nt; ++u) {
    probe_halo<<<grid, block, 0, st>>>(u % 2 ? s0 : s1, u % 2 ? s1 : s0,
                                       alpha, t1, t2, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
