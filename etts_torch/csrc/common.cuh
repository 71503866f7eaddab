// Device helpers shared by the etts_torch kernels (sm_90a).
//
// matvec1 / matvec: a whole block computes y = W x (+ bias) for one vector,
// or for up to MAXM vectors at once, with W bf16 in row-major (out, in)
// layout (torch Linear layout) in global memory, x and y f32 in shared
// memory, f32 accumulation. A warp owns whole output rows; its lanes read a
// row in 16-byte chunks (8 bf16 values), 512 contiguous bytes per load.
// The per-step weights of both kernels are larger than one SM's shared
// memory, so they are streamed from global memory each step and stay
// resident in the 50 MB L2 across steps.
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

enum Act { ACT_NONE = 0, ACT_RELU = 1 };

// y_m[o] = act(sum_i W[o, i] * x_m[i] + bias[o]) for m < M (M <= MAXM),
// x_m = x + m * xs, y_m = y + m * ys. Ends with no barrier: the caller
// syncs before reading y.
template <int MAXM>
__device__ void matvec(const __nv_bfloat16* __restrict__ W, int in, int out,
                       const float* x, int xs, float* y, int ys, int M,
                       const float* __restrict__ bias, int act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool vec = (in & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  for (int o = warp; o < out; o += nw) {
    float acc[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) acc[m] = 0.f;
    const __nv_bfloat16* row = W + (size_t)o * in;
    if (vec) {
#pragma unroll 2
      for (int i = lane * 8; i < in; i += 256) {
        uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + i));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float w[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 f = __bfloat1622float2(h[j]);
          w[2 * j] = f.x;
          w[2 * j + 1] = f.y;
        }
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m < M) {
            const float* xm = x + m * xs + i;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[m] = fmaf(w[j], xm[j], acc[m]);
          }
        }
      }
    } else {
      for (int i = lane; i < in; i += 32) {
        float w = __bfloat162float(row[i]);
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
          if (m < M) acc[m] = fmaf(w, x[m * xs + i], acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
        float v = warp_sum(acc[m]);
        if (lane == 0) {
          if (bias) v += bias[o];
          if (act == ACT_RELU) v = fmaxf(v, 0.f);
          y[m * ys + o] = v;
        }
      }
    }
  }
}

// y[o] = act(sum_i W[o, i] * x[i] + bias[o]) for one vector. Each warp
// takes 4 rows at a time so that 4 row loads are in flight per warp, which
// the latency of L2 reads needs; ends with no barrier.
__device__ void matvec1(const __nv_bfloat16* __restrict__ W, int in, int out,
                        const float* x, float* y,
                        const float* __restrict__ bias, int act) {
  constexpr int R = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool vec = (in & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  for (int o0 = warp * R; o0 < out; o0 += nw * R) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (vec) {
#pragma unroll 2
      for (int i = lane * 8; i < in; i += 256) {
        uint4 raw[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          raw[r] = o0 + r < out
                       ? __ldg(reinterpret_cast<const uint4*>(
                             W + (size_t)(o0 + r) * in + i))
                       : make_uint4(0u, 0u, 0u, 0u);
        float xv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[j] = x[i + j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&raw[r]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float2 f = __bfloat1622float2(h[j]);
            acc[r] = fmaf(f.x, xv[2 * j], acc[r]);
            acc[r] = fmaf(f.y, xv[2 * j + 1], acc[r]);
          }
        }
      }
    } else {
      for (int i = lane; i < in; i += 32) {
        float xi = x[i];
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (o0 + r < out)
            acc[r] = fmaf(__bfloat162float(W[(size_t)(o0 + r) * in + i]), xi,
                          acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = warp_sum(acc[r]);
      if (lane == 0 && o0 + r < out) {
        if (bias) v += bias[o0 + r];
        if (act == ACT_RELU) v = fmaxf(v, 0.f);
        y[o0 + r] = v;
      }
    }
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
