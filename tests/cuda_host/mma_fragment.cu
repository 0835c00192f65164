// One warp's m16n8k8 TF32 product through cuda_host.h's emulated mma.sync:
// A (16x8), B (8x8, depth by column) and C (16x8), all row-major, of TF32
// values (small integers: their fp32 bits as they stand), loaded into the
// PTX ISA's register fragments (g = lane >> 2, t = lane % 4: a0..a3
// at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b0, b1 at (t, g),
// (t + 4, g); c0..c3 at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)),
// and D = C + A @ B stored over C. `mutate` swaps the rows of one fragment
// (1: A's rows g and g + 8; 2: B's rows t and t + 4; 3: C's rows g and
// g + 8), a mistake that a test of the layout must catch. Host-only: built
// with g++ against cuda_host.h by tests/test_torch_layout_probe.py.
#include <cuda_runtime.h>

__global__ void fragment_product(const float* a, const float* b, float* c,
                                 int mutate) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int ra0 = mutate == 1 ? g + 8 : g, ra1 = mutate == 1 ? g : g + 8;
  const int kb0 = mutate == 2 ? t + 4 : t, kb1 = mutate == 2 ? t : t + 4;
  const int rc0 = mutate == 3 ? g + 8 : g, rc1 = mutate == 3 ? g : g + 8;
  const unsigned fa[4] = {
      __float_as_uint(a[ra0 * 8 + t]), __float_as_uint(a[ra1 * 8 + t]),
      __float_as_uint(a[ra0 * 8 + t + 4]), __float_as_uint(a[ra1 * 8 + t + 4])};
  const unsigned fb[2] = {__float_as_uint(b[kb0 * 8 + g]),
                          __float_as_uint(b[kb1 * 8 + g])};
  float fc[4] = {c[rc0 * 8 + 2 * t], c[rc0 * 8 + 2 * t + 1],
                 c[rc1 * 8 + 2 * t], c[rc1 * 8 + 2 * t + 1]};
  __syncwarp();   // every lane has read C before any lane writes D
  host::mma_m16n8k8_tf32(fc, fa, fb);
  c[g * 8 + 2 * t] = fc[0];
  c[g * 8 + 2 * t + 1] = fc[1];
  c[(g + 8) * 8 + 2 * t] = fc[2];
  c[(g + 8) * 8 + 2 * t + 1] = fc[3];
}

// D = C + A @ B over c, by one warp. Returns the launch error, 0 if none.
extern "C" int rdt_fragment_product(const float* a, const float* b, float* c,
                                    int mutate) {
  fragment_product<<<1, 32>>>(a, b, c, mutate);
  return (int)cudaGetLastError();
}

