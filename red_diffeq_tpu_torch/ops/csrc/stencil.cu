// Acoustic FD time stepper for Hopper (sm_90a): forward step, the tape-free
// adjoint step, and the taped pair (tape replay step, taped adjoint step),
// with a plain C interface loaded through ctypes
// (red_diffeq_tpu_torch/ops/stencil.py).
//
// fwd_step replaces _fwd_kernel (red_diffeq_tpu/ops/stencil.py:150-231,
// launched by _run_fwd at :510). bwd_reverse_step replaces
// _bwd_reverse_kernel (:352-443, launched by _run_bwd_reverse at :632).
// tape_step replaces _tape_kernel (:233-268, launched by _run_tape at :550)
// and bwd_tape_step replaces _bwd_kernel (:271-349, launched by _run_bwd at
// :582); the JAX package takes that pair when its t2 guard trips.
//
// Recursion, per (sample b, shot s) field of Hp x Wp cells:
//   s_m = t1*s_{m-1} - t2*s_{m-2} + alpha*L(s_{m-1}),  then row isz += inj*src[k]
// with L the circular 4th-order Laplacian (C2 = 4/3, C3 = -1/12).
//
// Bound on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32). Per cell and
// step the forward and the tape replay do 14 fp32 operations, the tape-free
// adjoint 35 and the taped adjoint 30. Counting each chunk call's inputs and
// outputs (its start and end states or its tape, coefficients, receiver
// rows) once, one 1000-step pass at the headline (B=4, ns=5, 310x310, chunk
// 20) is bound at 0.53 ms by bytes (forward), 1.01 ms by operations
// (tape-free adjoint) and about 2.8 ms by bytes for each of the taped pair,
// whose 22-state tape (169 MB a chunk) is written once and read once;
// chip_smoke.py computes all four. Run one step per launch, as here, each
// launch re-reads the state from L2 or device memory, so these kernels are
// bound by that traffic and by the launch rate, far from those bounds.
//
// Design, simple and right first: one launch per time step, one thread per
// cell. A 310x310 fp32 field is 384 KB, above the 227 KB of shared memory
// a block may have, so the TPU's whole-field-resident program does not
// carry over; the batch-4 state (about 31 MB forward) lives in the 50 MB
// L2 between launches. Neighbour reads wrap around (circular stencil).
// The forward steps in place: s_m overwrites s_{m-2}, which only its own
// cell reads. The adjoints give one thread each (b, y, x) and loop over
// the shots, so the alpha/t1/t2 cotangents are summed over shots in one
// fixed order with no atomics. They need L(alpha*v) of v *after* the
// receiver injection, so each thread adds grec to the neighbour values on
// row igz itself. Build with -fmad=false: every multiply and add rounds as
// in the plain PyTorch version (same grouping as ops/stencil.py), which
// the rebuild's divide by t2 (error growth up to (1/t2)^chunk) needs.
// The taped pair does not keep the TPU's haloed tape blocks (U+2 states per
// grid iteration, so that one VMEM block serves one iteration): its tape is
// flat, chunk+2 states of (B, ns, Hp, Wp) with slot i = s_{i-1}, so slots 0
// and 1 are the chunk-start carry. tape_step reads slots m and m-1 and
// writes slot m+1; bwd_tape_step reads s_{m-1} and s_{m-2} from slots m
// and m-1 where bwd_reverse_step rebuilds s_{m-2}, and never divides by t2.
// The tape lives only during one chunk's backward, as in the JAX custom VJP.
// At the headline it is above the L2, so the taped pair streams from HBM.
// Later work: temporal blocking with a 2*U halo, clusters with distributed
// shared memory, one launch per chunk.

#include <cuda_runtime.h>

namespace {

constexpr float kC2 = (float)(4.0 / 3.0);
constexpr float kC3 = (float)(-1.0 / 12.0);
constexpr int kThreads = 256;

struct Nbr {
  int ym2, ym1, yp1, yp2, xm2, xm1, xp1, xp2;
};

__device__ __forceinline__ Nbr neighbours(int y, int x, int H, int W) {
  Nbr n;
  n.ym1 = y == 0 ? H - 1 : y - 1;
  n.ym2 = n.ym1 == 0 ? H - 1 : n.ym1 - 1;
  n.yp1 = y == H - 1 ? 0 : y + 1;
  n.yp2 = n.yp1 == H - 1 ? 0 : n.yp1 + 1;
  n.xm1 = x == 0 ? W - 1 : x - 1;
  n.xm2 = n.xm1 == 0 ? W - 1 : n.xm1 - 1;
  n.xp1 = x == W - 1 ? 0 : x + 1;
  n.xp2 = n.xp1 == W - 1 ? 0 : n.xp1 + 1;
  return n;
}

// L(f) at (y, x) for a field read through f(yy, xx), in the grouping of
// red_diffeq_tpu/solvers/acoustic.py:188-191 (roll(p, 1)[y] = p[y - 1]).
template <typename F>
__device__ __forceinline__ float lap4(const F& f, const Nbr& n, int y, int x) {
  return kC2 * (((f(n.ym1, x) + f(n.yp1, x)) + f(y, n.xm1)) + f(y, n.xp1)) +
         kC3 * (((f(n.ym2, x) + f(n.yp2, x)) + f(y, n.xm2)) + f(y, n.xp2));
}

// s_m at cell (y, x) of field bs: p2 is s_{m-2} there, f1 the field
// s_{m-1}, c the cell's index in the (B, 1, H, W) coefficient fields.
__device__ __forceinline__ float step_cell(
    float p2, const float* __restrict__ f1, const float* __restrict__ alpha,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const float* __restrict__ inj, const float* __restrict__ src, int k,
    int bs, int c, int y, int x, int H, int W, int isz) {
  const Nbr n = neighbours(y, x, H, W);
  const auto at = [&](int yy, int xx) { return f1[yy * W + xx]; };
  float p = (t1[c] * f1[y * W + x] - t2[c] * p2) + alpha[c] * lap4(at, n, y, x);
  if (y == isz) p = p + inj[bs * W + x] * src[k];
  return p;
}

// One forward step. p0 holds s_{m-2} and receives s_m; p1 holds s_{m-1}.
__global__ void fwd_step(float* __restrict__ p0, const float* __restrict__ p1,
                         const float* __restrict__ alpha,
                         const float* __restrict__ t1,
                         const float* __restrict__ t2,
                         const float* __restrict__ inj,
                         const float* __restrict__ src, int k,
                         float* __restrict__ recs, int B, int ns, int H, int W,
                         int isz, int igz, int g0, int ng, int chunk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = H * W;
  if (idx >= B * ns * hw) return;
  const int x = idx % W;
  const int y = (idx / W) % H;
  const int bs = idx / hw;            // b * ns + s
  const int c = (bs / ns) * hw + y * W + x;
  const float p = step_cell(p0[idx], p1 + (size_t)bs * hw, alpha, t1, t2, inj,
                            src, k, bs, c, y, x, H, W, isz);
  p0[idx] = p;
  if (y == igz && x >= g0 && x < g0 + ng)
    recs[((size_t)bs * chunk + k) * ng + (x - g0)] = p;
}

// One step m (k = m - 1) of the tape replay: prev and cur hold s_{m-2} and
// s_{m-1} (tape slots m-1 and m), out receives s_m (slot m+1). The
// arithmetic of fwd_step, with no receiver rows.
__global__ void tape_step(const float* __restrict__ prev,
                          const float* __restrict__ cur,
                          float* __restrict__ out,
                          const float* __restrict__ alpha,
                          const float* __restrict__ t1,
                          const float* __restrict__ t2,
                          const float* __restrict__ inj,
                          const float* __restrict__ src, int k, int B, int ns,
                          int H, int W, int isz) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = H * W;
  if (idx >= B * ns * hw) return;
  const int x = idx % W;
  const int y = (idx / W) % H;
  const int bs = idx / hw;
  const int c = (bs / ns) * hw + y * W + x;
  out[idx] = step_cell(prev[idx], cur + (size_t)bs * hw, alpha, t1, t2, inj,
                       src, k, bs, c, y, x, H, W, isz);
}

// One reversed step m (k = m - 1) of the tape-free adjoint, one thread per
// (b, y, x) looping over the shots.
//   u_in, v_in: cotangents of s_{m-1}, s_m (v before the receiver injection)
//   u_out, v_out: cotangents of s_{m-2}, s_{m-1}
//   s_m: holds s_m, receives the rebuilt s_{m-2};  s_m1: holds s_{m-1}
__global__ void bwd_reverse_step(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ s_m, const float* __restrict__ s_m1,
    const float* __restrict__ grec, const float* __restrict__ alpha,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const float* __restrict__ inj, const float* __restrict__ src, int k,
    float* __restrict__ galpha, float* __restrict__ gt1,
    float* __restrict__ gt2, float* __restrict__ ginj, int B, int ns, int H,
    int W, int isz, int igz, int g0, int ng, int chunk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = H * W;
  if (idx >= B * hw) return;
  const int x = idx % W;
  const int y = (idx / W) % H;
  const int b = idx / hw;
  const int cy = y * W + x;
  const float* al = alpha + (size_t)b * hw;
  const float a = al[cy];
  const float tt1 = t1[idx];
  const float tt2 = t2[idx];
  const float inv_t2 = 1.0f / tt2;
  const float srck = src[k];
  const Nbr n = neighbours(y, x, H, W);
  float ga = galpha[idx], g1 = gt1[idx], g2 = gt2[idx];
  for (int s = 0; s < ns; ++s) {
    const int bs = b * ns + s;
    const size_t f = (size_t)bs * hw;
    const float* vf = v_in + f;
    const float* sf = s_m1 + f;
    const float* gr = grec + ((size_t)bs * chunk + k) * ng;
    // v after the receiver injection, at any cell.
    const auto vv_at = [&](int yy, int xx) {
      float val = vf[yy * W + xx];
      if (yy == igz && xx >= g0 && xx < g0 + ng) val = val + gr[xx - g0];
      return val;
    };
    const auto s_at = [&](int yy, int xx) { return sf[yy * W + xx]; };
    const auto w_at = [&](int yy, int xx) { return al[yy * W + xx] * vv_at(yy, xx); };
    const float vv = vv_at(y, x);
    const float sm1 = sf[cy];
    const float lap_s = lap4(s_at, n, y, x);
    const float inj_field = y == isz ? inj[bs * W + x] * srck : 0.0f;
    const float sm2 = (((tt1 * sm1 + a * lap_s) + inj_field) - s_m[f + cy]) * inv_t2;
    if (y == isz) ginj[bs * W + x] = ginj[bs * W + x] + vv * srck;
    ga = ga + vv * lap_s;
    g1 = g1 + vv * sm1;
    g2 = g2 - vv * sm2;
    v_out[f + cy] = (u_in[f + cy] + tt1 * vv) + lap4(w_at, n, y, x);
    u_out[f + cy] = -tt2 * vv;
    s_m[f + cy] = sm2;
  }
  galpha[idx] = ga;
  gt1[idx] = g1;
  gt2[idx] = g2;
}

// One reversed step m (k = m - 1) of the taped adjoint, one thread per
// (b, y, x) looping over the shots: bwd_reverse_step with s_{m-2} read from
// the tape instead of rebuilt.
//   u_in, v_in: cotangents of s_{m-1}, s_m (v before the receiver injection)
//   u_out, v_out: cotangents of s_{m-2}, s_{m-1}
//   s_m1, s_m2: tape slots m and m-1, holding s_{m-1} and s_{m-2}
__global__ void bwd_tape_step(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    float* __restrict__ u_out, float* __restrict__ v_out,
    const float* __restrict__ s_m1, const float* __restrict__ s_m2,
    const float* __restrict__ grec, const float* __restrict__ alpha,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const float* __restrict__ src, int k, float* __restrict__ galpha,
    float* __restrict__ gt1, float* __restrict__ gt2,
    float* __restrict__ ginj, int B, int ns, int H, int W, int isz, int igz,
    int g0, int ng, int chunk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = H * W;
  if (idx >= B * hw) return;
  const int x = idx % W;
  const int y = (idx / W) % H;
  const int b = idx / hw;
  const int cy = y * W + x;
  const float* al = alpha + (size_t)b * hw;
  const float tt1 = t1[idx];
  const float tt2 = t2[idx];
  const float srck = src[k];
  const Nbr n = neighbours(y, x, H, W);
  float ga = galpha[idx], g1 = gt1[idx], g2 = gt2[idx];
  for (int s = 0; s < ns; ++s) {
    const int bs = b * ns + s;
    const size_t f = (size_t)bs * hw;
    const float* vf = v_in + f;
    const float* sf = s_m1 + f;
    const float* gr = grec + ((size_t)bs * chunk + k) * ng;
    // v after the receiver injection, at any cell.
    const auto vv_at = [&](int yy, int xx) {
      float val = vf[yy * W + xx];
      if (yy == igz && xx >= g0 && xx < g0 + ng) val = val + gr[xx - g0];
      return val;
    };
    const auto s_at = [&](int yy, int xx) { return sf[yy * W + xx]; };
    const auto w_at = [&](int yy, int xx) { return al[yy * W + xx] * vv_at(yy, xx); };
    const float vv = vv_at(y, x);
    const float sm1 = sf[cy];
    const float lap_s = lap4(s_at, n, y, x);
    if (y == isz) ginj[bs * W + x] = ginj[bs * W + x] + vv * srck;
    ga = ga + vv * lap_s;
    g1 = g1 + vv * sm1;
    g2 = g2 - vv * s_m2[f + cy];
    v_out[f + cy] = (u_in[f + cy] + tt1 * vv) + lap4(w_at, n, y, x);
    u_out[f + cy] = -tt2 * vv;
  }
  galpha[idx] = ga;
  gt1[idx] = g1;
  gt2[idx] = g2;
}

inline unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// `chunk` forward steps on PyTorch's stream. x holds s_{-1} and y s_0 on
// entry; steps alternate between them, so s_chunk ends in y when chunk is
// even and in x when it is odd. recs: (B, ns, chunk, ng). Returns the first
// launch error, 0 if none.
extern "C" int rdt_fwd_chunk(float* x, float* y, const float* alpha,
                             const float* t1, const float* t2,
                             const float* inj, const float* src, float* recs,
                             int B, int ns, int H, int W, int isz, int igz,
                             int g0, int ng, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks((long long)B * ns * H * W);
  for (int k = 0; k < chunk; ++k) {
    fwd_step<<<grid, kThreads, 0, st>>>(x, y, alpha, t1, t2, inj, src, k, recs,
                                        B, ns, H, W, isz, igz, g0, ng, chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* t = x; x = y; y = t;
  }
  return 0;
}

// The adjoint of one chunk on PyTorch's stream, steps chunk-1 down to 0.
// (u, v) and (u2, v2) alternate, so the cotangents of the chunk's start
// states end in (u, v) when chunk is even and in (u2, v2) when it is odd.
// s_m / s_m1 enter as s_chunk / s_{chunk-1} and are consumed. galpha, gt1,
// gt2 (B, 1, H, W) and ginj (B, ns, 1, W) accumulate and must be zeroed by
// the caller. Returns the first launch error, 0 if none.
extern "C" int rdt_bwd_reverse_chunk(
    float* u, float* v, float* u2, float* v2, float* s_m, float* s_m1,
    const float* grec, const float* alpha, const float* t1, const float* t2,
    const float* inj, const float* src, float* galpha, float* gt1, float* gt2,
    float* ginj, int B, int ns, int H, int W, int isz, int igz, int g0, int ng,
    int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks((long long)B * H * W);
  for (int k = chunk - 1; k >= 0; --k) {
    bwd_reverse_step<<<grid, kThreads, 0, st>>>(
        u, v, u2, v2, s_m, s_m1, grec, alpha, t1, t2, inj, src, k, galpha,
        gt1, gt2, ginj, B, ns, H, W, isz, igz, g0, ng, chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* t;
    t = u; u = u2; u2 = t;
    t = v; v = v2; v2 = t;
    t = s_m; s_m = s_m1; s_m1 = t;
  }
  return 0;
}

// The tape of one chunk on PyTorch's stream: chunk + 2 states of B*ns*H*W
// cells, slot i = s_{i-1}. The caller fills slots 0 and 1 with the
// chunk-start carry; steps k = 0 .. chunk-1 write slots 2 .. chunk+1.
// Returns the first launch error, 0 if none.
extern "C" int rdt_tape_chunk(float* tape, const float* alpha, const float* t1,
                              const float* t2, const float* inj,
                              const float* src, int B, int ns, int H, int W,
                              int isz, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t slot = (size_t)B * ns * H * W;
  const unsigned grid = blocks((long long)slot);
  for (int k = 0; k < chunk; ++k) {
    tape_step<<<grid, kThreads, 0, st>>>(tape + k * slot, tape + (k + 1) * slot,
                                         tape + (k + 2) * slot, alpha, t1, t2,
                                         inj, src, k, B, ns, H, W, isz);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The taped adjoint of one chunk on PyTorch's stream, steps chunk-1 down to
// 0, reading the tape written by rdt_tape_chunk (slots 0 .. chunk). (u, v)
// and (u2, v2) alternate as in rdt_bwd_reverse_chunk; galpha, gt1, gt2 and
// ginj accumulate and must be zeroed by the caller. Returns the first launch
// error, 0 if none.
extern "C" int rdt_bwd_tape_chunk(
    float* u, float* v, float* u2, float* v2, const float* tape,
    const float* grec, const float* alpha, const float* t1, const float* t2,
    const float* src, float* galpha, float* gt1, float* gt2, float* ginj,
    int B, int ns, int H, int W, int isz, int igz, int g0, int ng, int chunk,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t slot = (size_t)B * ns * H * W;
  const unsigned grid = blocks((long long)B * H * W);
  for (int k = chunk - 1; k >= 0; --k) {
    bwd_tape_step<<<grid, kThreads, 0, st>>>(
        u, v, u2, v2, tape + (k + 1) * slot, tape + k * slot, grec, alpha, t1,
        t2, src, k, galpha, gt1, gt2, ginj, B, ns, H, W, isz, igz, g0, ng,
        chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* t;
    t = u; u = u2; u2 = t;
    t = v; v = v2; v2 = t;
  }
  return 0;
}
