// Fused single-stream AR TransformerTTS decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel etts/ops/pallas/decoder_step.py
// (_fused_decode_call -> _make_kernel, pallas_call at :464; inputs from
// build_decode_inputs).
//
// What it computes: the whole b = 1 decode in one launch. Per step t:
// prenet (two relu dense layers, each with always-on dropout at a runtime
// rate), x * sqrt(d) + pe[t] (table pre-strided by r), then per block:
// fused QKV, KV-cache write at row t, causal self-attention, concat-query
// output projection, LN(so), LN(so + x); cross-attention on the precomputed
// encoder K/V, concat-query projection, LN(co + x1); FFN d1 -> d2 -> LN ->
// relu, LN(x2 + y). Then FinalProj to r frames, the causal postnet on the r
// new frames with BatchNorm folded to scale and shift, the 3-class stop
// head on each pre-postnet frame (the first firing frame sets the length),
// the attention-completion stop (argmax of the head-summed last-block
// cross-attention >= n_enc - 2 for `patience` steps), the frame cap, and
// the feedback of the last postnet frame.
//
// What bounds it on the H100: every step depends on the previous one and
// reads all ~5.7 M bf16 weights (11.4 MB at flagship width) once; with one
// query the arithmetic is 2 flops per weight, so the step is a weight read.
//
// Design (first, simple version): one block of 1024 threads runs every step.
// The weights stay in global memory, L2-resident across steps (11.4 MB <<
// 50 MB), and are streamed through warp-per-row matrix-vector products with
// f32 accumulation; activations live in shared memory. The postnet runs its
// r new frames through each layer together (one read of each layer's
// weights per step, not r). KV caches are bf16 in global memory. The bound
// on this design is one SM's L2 read rate; spreading the weights over many
// SMs with grid-wide barriers is the next step.
//
// Randomness: Philox uniforms indexed by (step, layer, unit), seeded from
// the wrapper, or caller-given uniforms (`noise`, (t_max, P + d)).
#include "common.cuh"

using etts::matvec;
using etts::matvec1;

namespace {

constexpr int MAXM = 8;  // frames per postnet matvec pass

struct Params {
  const float* pe;                         // (t_max, d)
  const __nv_bfloat16* pw1; const float* pb1;   // (P, mel)
  const __nv_bfloat16* pw2; const float* pb2;   // (d, P)
  const __nv_bfloat16* wqkv; const float* bqkv; // (nb, 3d, d)
  const __nv_bfloat16* wos; const float* bos;   // (nb, d, 2d) on [x | attn]
  const __nv_bfloat16* wqc; const float* bqc;   // (nb, d, d)
  const __nv_bfloat16* woc; const float* boc;   // (nb, d, 2d) on [x1 | attn2]
  const __nv_bfloat16* f1; const float* bf1;    // (nb, ffn, d)
  const __nv_bfloat16* f2; const float* bf2;    // (nb, d, ffn)
  const float* lns; const float* lnb;           // (nb, 5, d)
  const __nv_bfloat16* ck; const __nv_bfloat16* cv;  // (nb, n_enc, d)
  const __nv_bfloat16* fpw; const float* fpb;   // (r*mel, d)
  const __nv_bfloat16* pc0;                     // (cf, k*mel)
  const __nv_bfloat16* pcm;                     // (npost-2, cf, k*cf)
  const __nv_bfloat16* pcl;                     // (mel, k*cf)
  const float* ps; const float* psh;            // (npost, pw) folded BN
  const float* outs; const float* outb;         // (mel)
  const __nv_bfloat16* stopw; const float* stopb;  // (3, mel)
  __nv_bfloat16* kc; __nv_bfloat16* vc;         // (nb, t_max, d) scratch
  const float* noise;                           // (t_max, P + d) or null
  float* out;                                   // (t_max*r, mel), zeroed
  int* len_out;                                 // (length, steps)
  int t_max, r, d, nh, mel, P, ffn, n_enc, nb, k, npost, cf, pw;
  int stop_index, stop_enabled, patience, frame_cap;
  float rate, start_value;
  unsigned long long seed;
};

__device__ void layer_norm(float* y, const float* x, const float* g,
                           const float* b, int n, float* red) {
  // one warp: two-pass mean / variance, eps 1e-6
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int i = threadIdx.x; i < n; i += 32) s += x[i];
    float mu = etts::warp_sum(s) / n;
    float v = 0.f;
    for (int i = threadIdx.x; i < n; i += 32) {
      float c = x[i] - mu;
      v += c * c;
    }
    float rs = rsqrtf(etts::warp_sum(v) / n + 1e-6f);
    if (threadIdx.x == 0) { red[0] = mu; red[1] = rs; }
  }
  __syncthreads();
  float mu = red[0], rs = red[1];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    y[i] = (x[i] - mu) * rs * g[i] + b[i];
  __syncthreads();
}

// out[h*depth + i] = sum_j softmax_j(q_h . K[j]_h / sqrt(depth)) V[j]_h over
// rows j < n. If psum, psum[j] = sum_h p_h[j]. Ends synchronised.
__device__ void attend(const float* q, const __nv_bfloat16* K,
                       const __nv_bfloat16* V, int n, int d, int nh,
                       float* scores, int L, float* out, float* psum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, depth = d / nh;
  const float inv = rsqrtf((float)depth);
  for (int e = warp; e < nh * n; e += nw) {
    int h = e / n, j = e % n;
    const __nv_bfloat16* kr = K + (size_t)j * d + h * depth;
    float s = 0.f;
    for (int i = lane; i < depth; i += 32)
      s = fmaf(q[h * depth + i], __bfloat162float(kr[i]), s);
    s = etts::warp_sum(s);
    if (lane == 0) scores[h * L + j] = s * inv;
  }
  __syncthreads();
  if (warp < nh) {
    float* sc = scores + warp * L;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sc[j]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      float e = expf(sc[j] - m);
      sc[j] = e;
      sum += e;
    }
    sum = etts::warp_sum(sum);
    for (int j = lane; j < n; j += 32) sc[j] = sc[j] / sum;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float* p = scores + (c / depth) * L;
    float o = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j)
      o = fmaf(p[j], __bfloat162float(V[(size_t)j * d + c]), o);
    out[c] = o;
  }
  if (psum) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float s = 0.f;
      for (int h = 0; h < nh; ++h) s += scores[h * L + j];
      psum[j] = s;
    }
  }
  __syncthreads();
}

__device__ float dropout(const Params& p, float v, int t, int layer, int j,
                         int off) {
  if (p.rate == 0.f && !p.noise) return v;
  float keep = 1.f - p.rate;
  float u = p.noise ? p.noise[(size_t)t * (p.P + p.d) + off + j]
                    : etts::philox_uniform(p.seed, (unsigned long long)t,
                                           (unsigned)layer, (unsigned)j);
  return u < keep ? v / fmaxf(keep, 1e-8f) : 0.f;
}

__global__ void __launch_bounds__(1024) decode_loop(Params p) {
  extern __shared__ float sm[];
  const int d = p.d, mel = p.mel, r = p.r, k = p.k, cf = p.cf;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int L = max(p.t_max, p.n_enc);
  float* frame = sm;                  // mel
  float* hp = frame + mel;            // P
  float* xa = hp + p.P;               // 2d: [x | attn]
  float* qkv = xa + 2 * d;            // 3d
  float* x1a = qkv + 3 * d;           // 2d: [x1 | attn2]
  float* so = x1a + 2 * d;            // d
  float* x2 = so + d;                 // d
  float* y1 = x2 + d;                 // ffn
  float* y2 = y1 + p.ffn;             // d
  float* mlin = y2 + d;               // r * mel
  float* z = mlin + r * mel;          // r * mel
  float* slog = z + r * mel;          // r * 3
  float* scores = slog + 3 * r;       // nh * L
  float* psum = scores + p.nh * L;    // n_enc
  float* red = psum + p.n_enc;        // 2
  float* hist = red + 2;              // per layer ((k-1)+r) * in_l
  __shared__ int st[4];               // stopped, length, attn counter, step

  auto hist_of = [&](int l) {
    float* h = hist;
    for (int i = 0; i < l; ++i) h += (k - 1 + r) * (i == 0 ? mel : cf);
    return h;
  };
  float* hlast = hist_of(p.npost);
  for (float* h = hist; h < hlast; h += nt)
    if (h + tid < hlast) h[tid] = 0.f;
  for (int i = tid; i < mel; i += nt) frame[i] = p.start_value;
  if (tid == 0) { st[0] = 0; st[1] = 0; st[2] = 0; st[3] = 0; }
  __syncthreads();

  const float sqrt_d = sqrtf((float)d);
  const int D3 = 3 * d;
  for (int t = 0; t < p.t_max; ++t) {
    if (st[0]) break;
    // ---- prenet ----
    matvec1(p.pw1, mel, p.P, frame, hp, p.pb1, etts::ACT_RELU);
    __syncthreads();
    for (int i = tid; i < p.P; i += nt) hp[i] = dropout(p, hp[i], t, 0, i, 0);
    __syncthreads();
    matvec1(p.pw2, p.P, d, hp, xa, p.pb2, etts::ACT_RELU);
    __syncthreads();
    for (int i = tid; i < d; i += nt)
      xa[i] = dropout(p, xa[i], t, 1, i, p.P) * sqrt_d + p.pe[(size_t)t * d + i];
    __syncthreads();
    // ---- decoder blocks ----
    for (int blk = 0; blk < p.nb; ++blk) {
      const float* g = p.lns + (size_t)blk * 5 * d;
      const float* bb = p.lnb + (size_t)blk * 5 * d;
      __nv_bfloat16* kc = p.kc + (size_t)blk * p.t_max * d;
      __nv_bfloat16* vc = p.vc + (size_t)blk * p.t_max * d;
      matvec1(p.wqkv + (size_t)blk * D3 * d, d, D3, xa, qkv, p.bqkv + (size_t)blk * D3, etts::ACT_NONE);
      __syncthreads();
      for (int i = tid; i < d; i += nt) {
        kc[(size_t)t * d + i] = __float2bfloat16(qkv[d + i]);
        vc[(size_t)t * d + i] = __float2bfloat16(qkv[2 * d + i]);
      }
      __syncthreads();
      attend(qkv, kc, vc, t + 1, d, p.nh, scores, L, xa + d, nullptr);
      matvec1(p.wos + (size_t)blk * d * 2 * d, 2 * d, d, xa, so, p.bos + (size_t)blk * d, etts::ACT_NONE);
      __syncthreads();
      layer_norm(so, so, g, bb, d, red);
      for (int i = tid; i < d; i += nt) so[i] += xa[i];
      __syncthreads();
      layer_norm(x1a, so, g + d, bb + d, d, red);
      matvec1(p.wqc + (size_t)blk * d * d, d, d, x1a, qkv, p.bqc + (size_t)blk * d, etts::ACT_NONE);
      __syncthreads();
      const bool want_p = p.patience >= 0 && blk == p.nb - 1;
      attend(qkv, p.ck + (size_t)blk * p.n_enc * d,
             p.cv + (size_t)blk * p.n_enc * d, p.n_enc, d, p.nh, scores, L,
             x1a + d, want_p ? psum : nullptr);
      if (want_p && tid < 32) {
        float best = -INFINITY;
        int arg = 0x7fffffff;
        for (int j = tid; j < p.n_enc; j += 32)
          if (psum[j] > best || (psum[j] == best && j < arg)) {
            best = psum[j];
            arg = j;
          }
        etts::warp_argmax(best, arg);
        if (tid == 0) st[2] = arg >= p.n_enc - 2 ? st[2] + 1 : 0;
      }
      matvec1(p.woc + (size_t)blk * d * 2 * d, 2 * d, d, x1a, so, p.boc + (size_t)blk * d, etts::ACT_NONE);
      __syncthreads();
      for (int i = tid; i < d; i += nt) so[i] += x1a[i];
      __syncthreads();
      layer_norm(x2, so, g + 2 * d, bb + 2 * d, d, red);
      matvec1(p.f1 + (size_t)blk * p.ffn * d, d, p.ffn, x2, y1, p.bf1 + (size_t)blk * p.ffn, etts::ACT_NONE);
      __syncthreads();
      matvec1(p.f2 + (size_t)blk * d * p.ffn, p.ffn, d, y1, y2, p.bf2 + (size_t)blk * d, etts::ACT_NONE);
      __syncthreads();
      layer_norm(y2, y2, g + 3 * d, bb + 3 * d, d, red);
      for (int i = tid; i < d; i += nt) y2[i] = x2[i] + fmaxf(y2[i], 0.f);
      __syncthreads();
      layer_norm(xa, y2, g + 4 * d, bb + 4 * d, d, red);
    }
    // ---- final projection: r frames of mel ----
    matvec1(p.fpw, d, r * mel, xa, mlin, p.fpb, etts::ACT_NONE);
    __syncthreads();
    // ---- causal postnet over the r new frames ----
    {
      float* h0 = hist_of(0);
      for (int i = tid; i < r * mel; i += nt) h0[(k - 1) * mel + i] = mlin[i];
      __syncthreads();
      for (int l = 0; l < p.npost; ++l) {
        const int in = l == 0 ? mel : cf;
        const bool last = l == p.npost - 1;
        const int on = last ? mel : cf;
        const __nv_bfloat16* W =
            l == 0 ? p.pc0
                   : last ? p.pcl : p.pcm + (size_t)(l - 1) * cf * k * cf;
        float* hin = hist_of(l);
        float* dst = last ? z : hist_of(l + 1) + (k - 1) * cf;
        for (int f0 = 0; f0 < r; f0 += MAXM)
          matvec<MAXM>(W, k * in, on, hin + f0 * in, in, dst + f0 * on, on,
                       min(MAXM, r - f0), nullptr, etts::ACT_NONE);
        __syncthreads();
        const float* s = p.ps + (size_t)l * p.pw;
        const float* sh = p.psh + (size_t)l * p.pw;
        for (int i = tid; i < r * on; i += nt) {
          float v = dst[i] * s[i % on] + sh[i % on];
          dst[i] = last ? v : tanhf(v);
        }
        __syncthreads();
      }
      // slide every layer's history by r frames (a forward memmove in
      // block-wide chunks: a chunk's reads never reach earlier writes)
      for (int l = 0; l < p.npost; ++l) {
        const int in = l == 0 ? mel : cf;
        const int n = (k - 1) * in;
        float* hin = hist_of(l);
        for (int base = 0; base < n; base += nt) {
          const int i = base + tid;
          float v = i < n ? hin[r * in + i] : 0.f;
          __syncthreads();
          if (i < n) hin[i] = v;
          __syncthreads();
        }
      }
    }
    // ---- outputs, stop head, guards, feedback ----
    for (int i = tid; i < r * mel; i += nt) {
      int c = i % mel;
      float v = (mlin[i] + z[i]) * p.outs[c] + p.outb[c];
      z[i] = v;
      p.out[(size_t)t * r * mel + i] = v;
    }
    matvec<MAXM>(p.stopw, mel, 3, mlin, mel, slog, 3, min(MAXM, r), p.stopb,
                 etts::ACT_NONE);
    for (int f0 = MAXM; f0 < r; f0 += MAXM)
      matvec<MAXM>(p.stopw, mel, 3, mlin + f0 * mel, mel, slog + f0 * 3, 3,
                   min(MAXM, r - f0), p.stopb, etts::ACT_NONE);
    __syncthreads();
    if (tid == 0) {
      st[1] = (t + 1) * r;
      if (p.stop_enabled) {
        for (int f = 0; f < r; ++f) {
          const float* lg = slog + 3 * f;
          int cls = 0;
          if (lg[1] > lg[cls]) cls = 1;
          if (lg[2] > lg[cls]) cls = 2;
          if (cls == p.stop_index && !st[0]) {
            st[0] = 1;
            st[1] = t * r + f + 1;
          }
        }
      }
      if (p.patience >= 0 && st[2] >= p.patience && !st[0]) st[0] = 1;
      if (p.frame_cap >= 0 && (t + 1) * r >= p.frame_cap && !st[0]) {
        st[0] = 1;
        st[1] = min(st[1], p.frame_cap);
      }
      st[3] = t + 1;
    }
    for (int i = tid; i < mel; i += nt) frame[i] = z[(r - 1) * mel + i];
    __syncthreads();
  }
  if (tid == 0) {
    p.len_out[0] = st[1];
    p.len_out[1] = st[3];
  }
}

}  // namespace

// ptrs: the 40 pointers of Params in declaration order; ints: t_max, r, d,
// nh, mel, P, ffn, n_enc, nb, k, npost, cf, pw, stop_index, stop_enabled,
// patience (-1 = off), frame_cap (-1 = off). Returns the CUDA error code.
extern "C" int decode_loop_launch(void** ptrs, const int* ints, float rate,
                                  float start_value, unsigned long long seed,
                                  int threads, void* stream) {
  Params p;
  int n = 0;
  p.pe = (const float*)ptrs[n++];
  p.pw1 = (const __nv_bfloat16*)ptrs[n++]; p.pb1 = (const float*)ptrs[n++];
  p.pw2 = (const __nv_bfloat16*)ptrs[n++]; p.pb2 = (const float*)ptrs[n++];
  p.wqkv = (const __nv_bfloat16*)ptrs[n++]; p.bqkv = (const float*)ptrs[n++];
  p.wos = (const __nv_bfloat16*)ptrs[n++]; p.bos = (const float*)ptrs[n++];
  p.wqc = (const __nv_bfloat16*)ptrs[n++]; p.bqc = (const float*)ptrs[n++];
  p.woc = (const __nv_bfloat16*)ptrs[n++]; p.boc = (const float*)ptrs[n++];
  p.f1 = (const __nv_bfloat16*)ptrs[n++]; p.bf1 = (const float*)ptrs[n++];
  p.f2 = (const __nv_bfloat16*)ptrs[n++]; p.bf2 = (const float*)ptrs[n++];
  p.lns = (const float*)ptrs[n++]; p.lnb = (const float*)ptrs[n++];
  p.ck = (const __nv_bfloat16*)ptrs[n++]; p.cv = (const __nv_bfloat16*)ptrs[n++];
  p.fpw = (const __nv_bfloat16*)ptrs[n++]; p.fpb = (const float*)ptrs[n++];
  p.pc0 = (const __nv_bfloat16*)ptrs[n++];
  p.pcm = (const __nv_bfloat16*)ptrs[n++];
  p.pcl = (const __nv_bfloat16*)ptrs[n++];
  p.ps = (const float*)ptrs[n++]; p.psh = (const float*)ptrs[n++];
  p.outs = (const float*)ptrs[n++]; p.outb = (const float*)ptrs[n++];
  p.stopw = (const __nv_bfloat16*)ptrs[n++]; p.stopb = (const float*)ptrs[n++];
  p.kc = (__nv_bfloat16*)ptrs[n++]; p.vc = (__nv_bfloat16*)ptrs[n++];
  p.noise = (const float*)ptrs[n++];
  p.out = (float*)ptrs[n++];
  p.len_out = (int*)ptrs[n++];
  int i = 0;
  p.t_max = ints[i++]; p.r = ints[i++]; p.d = ints[i++]; p.nh = ints[i++];
  p.mel = ints[i++]; p.P = ints[i++]; p.ffn = ints[i++]; p.n_enc = ints[i++];
  p.nb = ints[i++]; p.k = ints[i++]; p.npost = ints[i++]; p.cf = ints[i++];
  p.pw = ints[i++]; p.stop_index = ints[i++]; p.stop_enabled = ints[i++];
  p.patience = ints[i++]; p.frame_cap = ints[i++];
  p.rate = rate;
  p.start_value = start_value;
  p.seed = seed;
  const int L = p.t_max > p.n_enc ? p.t_max : p.n_enc;
  size_t floats = p.mel + p.P + 2 * p.d + 3 * p.d + 2 * p.d + 3 * p.d +
                  p.ffn + 2 * p.r * p.mel + 3 * p.r + p.nh * L + p.n_enc + 2 +
                  (size_t)(p.k - 1 + p.r) * (p.mel + (p.npost - 1) * p.cf);
  size_t smem = floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_loop, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  decode_loop<<<1, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
