// Device helpers shared by the etts_torch kernels (sm_90a): warp
// reductions and the counter-based Philox generator of the dropout and
// sampling uniforms.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace etts {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// argmax over a warp: ties go to the smaller index (torch/jnp argmax).
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, s);
    int oi = __shfl_xor_sync(0xffffffffu, i, s);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// Philox4x32-10 (Salmon et al., SC'11): counter-based, so any (step, row,
// draw) can be generated independently and a chunked run continues the
// stream of a one-shot run exactly.
__device__ __forceinline__ uint4 philox4x32(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Uniform in (0, 1) for draw j of (a, b); 24-bit mantissa.
__device__ __forceinline__ float philox_uniform(unsigned long long seed,
                                                unsigned long long a,
                                                unsigned b, unsigned j) {
  uint4 r = philox4x32(
      make_uint4((unsigned)a, (unsigned)(a >> 32), b, j >> 2),
      make_uint2((unsigned)seed, (unsigned)(seed >> 32)));
  unsigned v = (j & 3) == 0 ? r.x : (j & 3) == 1 ? r.y : (j & 3) == 2 ? r.z : r.w;
  return ((v >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

}  // namespace etts
