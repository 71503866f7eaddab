// Fused single-stream AR TransformerTTS decode for Hopper (sm_90a), run by
// one thread-block cluster.
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
// reads all ~5.7 M bf16 weights (11.4 MB at flagship width) once, through
// a chain of 41 dependent phases (prenet 2, 8 per decoder block counting
// the two attentions, FinalProj, 5 postnet convs, the stop step). With one
// query the arithmetic is 2 flops per weight, so a step costs the weight
// bytes over the L2 read rate of the SMs that stream them, plus one
// cluster barrier with its DSMEM exchange and one L2 round trip for each
// dependent phase; on the H100 the barrier alone costs about 1100-1700
// cycles, so the phases, not the bytes, set the step.
//
// Design: one cluster of CLUSTER blocks (one per SM, a hardware barrier
// and distributed shared memory between them). Each block owns 1/CLUSTER
// of the output rows of every product (prenet, QKV, projections, FFN,
// FinalProj, each postnet conv by output channel), in whole groups of 4
// rows, and streams only its slice of the weights from L2. A warp reduces
// a group of rows and its lanes 0..CLUSTER-1 each write the group's values
// straight into one block's shared copy of the output (one float4 or
// float2 DSMEM store a lane), then the cluster barrier; after it every
// block holds the whole vector. The elementwise work (LayerNorm chains,
// residuals, the attention combine, the stop head and guards, the history
// slide) runs in every block on identical data, so every block takes the
// same decisions and leaves the step loop at the same step. Attention is
// split by key rows: block b owns the cached rows j = b (mod CLUSTER),
// writes the KV row t when it owns it and reads only its own rows (one
// thread per head and row, 16-byte key loads), and publishes a partial
// softmax (max, sum, weighted V) that every block combines after the
// barrier. Activations are read from shared memory as float4, neighbouring
// lanes on neighbouring 16-byte words (no bank conflicts), against 8-byte
// weight loads; the postnet's frames share each weight read, 5 at a time.
//
// Randomness: Philox uniforms indexed by (step, layer, unit), seeded from
// the wrapper, or caller-given uniforms (`noise`, (t_max, P + d)); the
// owner of a unit draws it, so the result does not depend on CLUSTER.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#ifndef DECODE_CLUSTER
#define DECODE_CLUSTER 16
#endif

// Per-phase timer (built only with -DETTS_DECODE_TIMER): thread 0 of block
// 0 adds the clock64() cycles of each phase of each step to g_timer[phase];
// g_timer[NPHASE] gets the whole kernel's cycles and g_timer[NPHASE + 1]
// the steps run. Phases: prenet; per decoder block (summed over blocks)
// QKV + cache write, self-attention, output projection + LN, cross-attention
// query + attention, output projection + LN, FFN; FinalProj; postnet;
// stop head, guards and feedback. Each phase ends after the cluster
// barrier that publishes its output, so the barrier waits count in it.
enum { PH_PRENET, PH_QKV, PH_SELF, PH_SOUT, PH_CROSS, PH_COUT, PH_FFN,
       PH_FINAL, PH_POST, PH_STOP, NPHASE };
#ifdef ETTS_DECODE_TIMER
__device__ unsigned long long* g_timer;
#define TSTART(v) long long v = clock64()
#define TMARK(v, ph)                                            \
  do {                                                          \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                  \
      long long now_ = clock64();                               \
      g_timer[ph] += now_ - v;                                  \
      v = now_;                                                 \
    }                                                           \
  } while (0)
#define TEND(v, steps)                                          \
  do {                                                          \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                  \
      g_timer[NPHASE] += clock64() - v;                         \
      g_timer[NPHASE + 1] += (steps);                           \
    }                                                           \
  } while (0)
#else
#define TSTART(v)
#define TMARK(v, ph) do {} while (0)
#define TEND(v, steps) do {} while (0)
#endif

namespace {

constexpr int C = DECODE_CLUSTER;  // blocks in the cluster
constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;
constexpr int MAXM = 5;            // frames per postnet pass
constexpr int PG = 2;              // rows per warp group in the postnet
constexpr int UNROLL = 2;          // k-steps of weight loads in flight
constexpr int MAXJ = 16;           // d / 32 at most (LayerNorm in registers)
static_assert(C >= 2 && C <= 16 && 32 % C == 0, "a cluster of 2, 4, 8 or 16");

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

// The shared-memory layout, the same in every block of the cluster, so an
// offset in one block's copy names the same buffer in every other's. Each
// buffer starts on a 16-byte boundary.
struct Layout {
  int frame, hp, xa, qkv, x1a, so, q2, co, x2, y1, y2, part, slot, cand,
      opart, wts, scores, ls, slog, lns, stopw, hist, total;
  int n = 0;
  __host__ __device__ int take(int floats) {
    const int at = n;
    n += (floats + 3) & ~3;
    return at;
  }
  __host__ __device__ __forceinline__ explicit Layout(Params p) {
    const int L = p.t_max > p.n_enc ? p.t_max : p.n_enc;
    ls = (L + C - 1) / C;                 // own key rows at most
    slot = (p.d + 2 * p.nh + 3) & ~3;     // one block's attention partial
    frame = take(p.mel);
    hp = take(p.P);
    xa = take(2 * p.d);                   // [x | attn]
    qkv = take(3 * p.d);
    x1a = take(2 * p.d);                  // [x1 | attn2]
    so = take(p.d);
    q2 = take(p.d);
    co = take(p.d);
    x2 = take(p.d);
    y1 = take(p.ffn);
    y2 = take(p.d);
    part = take(C * slot);                // every block's partial
    cand = take(2 * C);                   // (psum max, its row) per block
    opart = take(slot);                   // this block's partial
    wts = take(C * p.nh);                 // each partial's weight
    scores = take(p.nh * ls);
    slog = take(3 * p.r);
    lns = take(2 * p.nb * 5 * p.d);       // LayerNorm gains, then biases
    stopw = take(3 * p.mel + 3);          // stop head weights, biases
    hist = take((p.k - 1 + p.r) * (p.mel + (p.npost - 1) * p.cf));
    total = n;
  }
};

// The first of block `rank`'s rows of n (a multiple of 4): every block owns
// whole groups of 4 rows.
__device__ __forceinline__ int row_lo(int n, int rank) {
  return 4 * ((n / 4) * rank / C);
}

__device__ __forceinline__ float2 bf2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Lane q < C of a warp stores the 4 (or 2) values into dst (aligned to
// their size) in the shared memory of the block of rank q: one remote store
// per lane.
__device__ __forceinline__ void push4(cg::cluster_group& cl, float* dst,
                                      const float (&v)[4], int lane) {
  if (lane < C)
    *cl.map_shared_rank(reinterpret_cast<float4*>(dst), lane) =
        make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void push4(cg::cluster_group& cl, float* dst,
                                      const float (&v)[2], int lane) {
  if (lane < C)
    *cl.map_shared_rank(reinterpret_cast<float2*>(dst), lane) =
        make_float2(v[0], v[1]);
}

// Rows [lo, hi) of y_m = scale * (W x_m) + shift for m < m_n (m_n <= M),
// x_m = x + m * xs, W bf16 (out, K) row-major in global memory (L2), x f32
// in shared memory, scale and shift per row (either may be null); lo, hi,
// K and xs multiples of 4 and x 16-byte aligned. Each warp takes groups of
// G (4 or 2) consecutive rows, the group's loads (scale and shift with the
// weights) in flight together; lane l reads weights k = 4l + 128i (8 bytes)
// and x as float4 at the same k, so neighbouring lanes read neighbouring
// words of shared memory (no bank conflicts). The G results of a group and
// vector are reduced over the warp (every lane holds them) and handed to
// epi(first row, m, values, lane). Ends with no barrier.
template <int G, int M, typename Epi>
__device__ __forceinline__ void rows_mv(const __nv_bfloat16* __restrict__ W,
                                        int K, int lo, int hi,
                                        const float* x, int xs, int m_n,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift,
                                        Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o0 = lo + G * warp; o0 < hi; o0 += G * NW) {
    float sc[G], sf[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      sc[i] = scale ? __ldg(scale + o0 + i) : 1.f;
      sf[i] = shift ? __ldg(shift + o0 + i) : 0.f;
    }
    float acc[G][M];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[i][m] = 0.f;
    const __nv_bfloat16* w0 = W + (size_t)o0 * K;
#pragma unroll UNROLL
    for (int k = 4 * lane; k < K; k += 128) {
      uint2 wr[G];
#pragma unroll
      for (int i = 0; i < G; ++i)
        wr[i] = __ldcg(reinterpret_cast<const uint2*>(w0 + (size_t)i * K + k));
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (m < m_n) {
          const float4 xv = *reinterpret_cast<const float4*>(x + m * xs + k);
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const float2 a = bf2(wr[i].x), b = bf2(wr[i].y);
            acc[i][m] = fmaf(a.x, xv.x, acc[i][m]);
            acc[i][m] = fmaf(a.y, xv.y, acc[i][m]);
            acc[i][m] = fmaf(b.x, xv.z, acc[i][m]);
            acc[i][m] = fmaf(b.y, xv.w, acc[i][m]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m < m_n) {
        float v[G];
#pragma unroll
        for (int i = 0; i < G; ++i)
          v[i] = fmaf(etts::warp_sum(acc[i][m]), sc[i], sf[i]);
        epi(o0, m, v, lane);
      }
    }
  }
}

// Prenet dropout of unit j of layer `layer` at step t: a caller-given
// uniform (noise row t, `stride` wide, at column off + j) or a Philox one.
__device__ __forceinline__ float dropout(float rate, const float* noise,
                                         int stride, unsigned long long seed,
                                         float v, int t, int layer, int j,
                                         int off) {
  if (rate == 0.f && !noise) return v;
  const float keep = 1.f - rate;
  const float u = noise ? noise[(size_t)t * stride + off + j]
                        : etts::philox_uniform(seed, (unsigned long long)t,
                                               (unsigned)layer, (unsigned)j);
  return u < keep ? v / fmaxf(keep, 1e-8f) : 0.f;
}

// What a prenet layer does to its outputs: relu, dropout (layer, columns
// from off in the noise rows), then v * scale + pe[row] when pe is given.
struct Prenet {
  float rate;
  const float* noise;
  int stride;
  unsigned long long seed;
  int t, layer, off;
  float scale;
  const float* pe;
};

// One vector's product W x + bias over this block's rows of n outputs,
// written into every block's dst; a prenet layer's activation and dropout
// when `pre` is given. Not inlined: one copy of the product's code serves
// every call and keeps the kernel small.
__device__ __noinline__ void block_mv(const __nv_bfloat16* W, int K, int n,
                                      int rank, const float* x,
                                      const float* bias, float* dst,
                                      bool is_pre, Prenet pre) {
  cg::cluster_group cl = cg::this_cluster();
  rows_mv<4, 1>(W, K, row_lo(n, rank), row_lo(n, rank + 1), x, 0, 1, nullptr,
                bias, [&](int o, int, float (&v)[4], int lane) {
                  if (is_pre) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                      v[i] = dropout(pre.rate, pre.noise, pre.stride, pre.seed,
                                     fmaxf(v[i], 0.f), pre.t, pre.layer, o + i,
                                     pre.off);
                      if (pre.pe) v[i] = v[i] * pre.scale + pre.pe[o + i];
                    }
                  }
                  push4(cl, dst + o, v, lane);
                });
}

// LayerNorm (eps 1e-6, two-pass mean and variance) of the n <= 32 * MAXJ
// values v[j] = x[lane + 32 j] that a warp holds, in place.
__device__ __forceinline__ void warp_ln(float (&v)[MAXJ], int n,
                                        const float* g, const float* b) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) s += v[j];
  const float mu = etts::warp_sum(s) / n;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j)
    if (lane + 32 * j < n) q += (v[j] - mu) * (v[j] - mu);
  const float rs = rsqrtf(etts::warp_sum(q) / n + 1e-6f);
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < n ? (v[j] - mu) * rs * g[i] + b[i] : 0.f;
  }
}

// The residual LayerNorm chains of a decoder block, out = LN_B(res + f(a))
// with f(a) = a (mode 0), LN_A(a) (mode 1) or relu(LN_A(a)) (mode 2). Every
// warp computes the whole vector from shared memory (no barrier between the
// two norms); warp w writes the elements lane + 32 j with j = w (mod NW).
// out must not alias a or res; the caller syncs before reading out.
__device__ __noinline__ void ln_chain(int mode, float* out, const float* a,
                                      const float* res, const float* gA,
                                      const float* bA, const float* gB,
                                      const float* bB, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) v[j] = lane + 32 * j < n ? a[lane + 32 * j] : 0.f;
  if (mode > 0) {
    warp_ln(v, n, gA, bA);
    if (mode == 2)
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) v[j] = fmaxf(v[j], 0.f);
  }
#pragma unroll
  for (int j = 0; j < MAXJ; ++j)
    if (lane + 32 * j < n) v[j] += res[lane + 32 * j];
  warp_ln(v, n, gB, bB);
#pragma unroll
  for (int j = 0; j < MAXJ; ++j)
    if (j % NW == warp && lane + 32 * j < n) out[lane + 32 * j] = v[j];
}

// This block's part of softmax(q_h . K_h / sqrt(depth)) V_h over the key
// rows j = rank (mod C), j < n: per head the max m_h of its scores, the sum
// l_h of exp(s - m_h) and the weighted sum of V rows, as [o (d) | m (nh) |
// l (nh)] into slot `rank` of every block's `part`. The exponentials stay
// in `scores` (head h at h * ls) for the attention-completion stop.
__device__ __noinline__ void attend_part(int rank, const float* q,
                            const __nv_bfloat16* K, const __nv_bfloat16* V,
                            int n, int d, int nh, float* scores, int ls,
                            float* opart, float* part, int slot) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int depth = d / nh;
  const float inv = rsqrtf((float)depth);
  const int nown = n > rank ? (n - 1 - rank) / C + 1 : 0;
  // one thread per (head, own row): the row's head slice in 16-byte loads
  for (int e = threadIdx.x; e < nh * nown; e += NT) {
    const int h = e / nown, i = e % nown;
    const uint4* kr = reinterpret_cast<const uint4*>(
        K + (size_t)(rank + C * i) * d + h * depth);
    const float* qh = q + h * depth;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < depth / 8; ++c) {
      const uint4 u = kr[c];
      const float4 qa = *reinterpret_cast<const float4*>(qh + 8 * c);
      const float4 qb = *reinterpret_cast<const float4*>(qh + 8 * c + 4);
      const float2 k0 = bf2(u.x), k1 = bf2(u.y), k2 = bf2(u.z), k3 = bf2(u.w);
      s = fmaf(qa.x, k0.x, s); s = fmaf(qa.y, k0.y, s);
      s = fmaf(qa.z, k1.x, s); s = fmaf(qa.w, k1.y, s);
      s = fmaf(qb.x, k2.x, s); s = fmaf(qb.y, k2.y, s);
      s = fmaf(qb.z, k3.x, s); s = fmaf(qb.w, k3.y, s);
    }
    scores[h * ls + i] = s * inv;
  }
  __syncthreads();
  for (int h = warp; h < nh; h += NW) {
    float* sc = scores + h * ls;
    float m = -INFINITY;
    for (int i = lane; i < nown; i += 32) m = fmaxf(m, sc[i]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    float sum = 0.f;
    for (int i = lane; i < nown; i += 32) {
      const float e = expf(sc[i] - m);
      sc[i] = e;
      sum += e;
    }
    sum = etts::warp_sum(sum);
    if (lane == 0) {
      opart[d + h] = m;
      opart[d + nh + h] = sum;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += NT) {
    const float* pr = scores + (c / depth) * ls;
    const __nv_bfloat16* vc = V + (size_t)rank * d + c;
    float o = 0.f;
#pragma unroll 8
    for (int i = 0; i < nown; ++i)
      o = fmaf(pr[i], __bfloat162float(vc[(size_t)C * i * d]), o);
    opart[c] = o;
  }
  __syncthreads();
  const int s4 = slot / 4;
  for (int e = threadIdx.x; e < C * s4; e += NT) {
    const int to = e / s4, w = e % s4;
    float4* dst = cl.map_shared_rank(
        reinterpret_cast<float4*>(part + rank * slot), to);
    dst[w] = reinterpret_cast<const float4*>(opart)[w];
  }
}

// Every block's partials -> the attention output (d), in every block alike.
// Lanes h * C + b of a warp hold block b's (max, sum) of head h and reduce
// them over the C lanes of the head; wts[b * nh + h] = exp(m_b - M) / L,
// the weight of block b's partial (and of its exponentials). Ends
// synchronised.
__device__ __noinline__ void attend_combine(const float* part, int slot,
                                            int d, int nh,
                               float* out, float* wts) {
  const int depth = d / nh;
  for (int base = (threadIdx.x >> 5) * 32; base < nh * C; base += NT) {
    const int e = base + (threadIdx.x & 31), h = e / C, b = e % C;
    const bool on = e < nh * C;
    const float m = on ? part[b * slot + d + h] : -INFINITY;
    float M = m;
#pragma unroll
    for (int s = C / 2; s > 0; s >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, s));
    const float w = on ? expf(m - M) : 0.f;
    float l = on ? part[b * slot + d + nh + h] * w : 0.f;
#pragma unroll
    for (int s = C / 2; s > 0; s >>= 1) l += __shfl_xor_sync(0xffffffffu, l, s);
    if (on) wts[b * nh + h] = w / l;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += NT) {
    const int h = c / depth;
    float o = 0.f;
#pragma unroll
    for (int b = 0; b < C; ++b) o = fmaf(part[b * slot + c], wts[b * nh + h], o);
    out[c] = o;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1) decode_cluster(Params p) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const Layout lay(p);
  const int d = p.d, mel = p.mel, r = p.r, k = p.k, cf = p.cf;
  const int tid = threadIdx.x;
  // the fields the epilogues read, as locals: no reference to p is taken
  const float rate = p.rate;
  const float* const noise = p.noise;
  const int nstride = p.P + p.d, P = p.P;
  const unsigned long long seed = p.seed;
  const float* const pe = p.pe;
  const float* const outs = p.outs;
  const float* const outb = p.outb;
  float* const out = p.out;
  float* const frame = sm + lay.frame;
  float* const hist = sm + lay.hist;
  float* const mlin = hist + (k - 1) * mel;  // FinalProj's r frames
  __shared__ int st[4];  // stopped, length, attention counter, steps

  // push v into element i of buffer `buf` in the block of rank `to`
  auto push = [&](float* buf, int i, float v, int to) {
    *cl.map_shared_rank(buf + i, to) = v;
  };
  auto hist_of = [&](int l) {
    return hist + (l == 0 ? 0 : (k - 1 + r) * (mel + (l - 1) * cf));
  };
  {
    const float* hend = hist_of(p.npost);
    for (float* h = hist + tid; h < hend; h += NT) *h = 0.f;
    const int nln = p.nb * 5 * d;
    for (int i = tid; i < nln; i += NT) {
      sm[lay.lns + i] = p.lns[i];
      sm[lay.lns + nln + i] = p.lnb[i];
    }
    for (int i = tid; i < 3 * mel; i += NT)
      sm[lay.stopw + i] = __bfloat162float(p.stopw[i]);
    if (tid < 3) sm[lay.stopw + 3 * mel + tid] = p.stopb[tid];
    for (int i = tid; i < mel; i += NT) frame[i] = p.start_value;
    if (tid == 0) { st[0] = 0; st[1] = 0; st[2] = 0; st[3] = 0; }
  }
  // every block has started and initialised before any remote store
  cl.sync();

  const float sqrt_d = sqrtf((float)d);
  const int D3 = 3 * d;
  TSTART(t_all);
  for (int t = 0; t < p.t_max; ++t) {
    if (st[0]) break;
    TSTART(tm);
    float* const xa = sm + lay.xa;
    // ---- prenet ----
    float* const hp = sm + lay.hp;
    Prenet pre{rate, noise, nstride, seed, t, 0, 0, 1.f, nullptr};
    block_mv(p.pw1, mel, p.P, rank, frame, p.pb1, hp, true, pre);
    cl.sync();
    pre.layer = 1;
    pre.off = P;
    pre.scale = sqrt_d;
    pre.pe = pe + (size_t)t * d;
    block_mv(p.pw2, p.P, d, rank, hp, p.pb2, xa, true, pre);
    cl.sync();
    TMARK(tm, PH_PRENET);
    // ---- decoder blocks ----
    for (int blk = 0; blk < p.nb; ++blk) {
      const float* g = sm + lay.lns + blk * 5 * d;
      const float* bb = g + p.nb * 5 * d;
      __nv_bfloat16* kc = p.kc + (size_t)blk * p.t_max * d;
      __nv_bfloat16* vc = p.vc + (size_t)blk * p.t_max * d;
      float* const qkv = sm + lay.qkv;
      float* const x1a = sm + lay.x1a;
      float* const part = sm + lay.part;
      float* const opart = sm + lay.opart;
      float* const scores = sm + lay.scores;
      float* const wts = sm + lay.wts;
      block_mv(p.wqkv + (size_t)blk * D3 * d, d, D3, rank, xa,
               p.bqkv + (size_t)blk * D3, qkv, false, pre);
      cl.sync();
      // the owner of row t writes it to the cache and reads it back
      if (t % C == rank)
        for (int i = tid; i < d; i += NT) {
          kc[(size_t)t * d + i] = __float2bfloat16(qkv[d + i]);
          vc[(size_t)t * d + i] = __float2bfloat16(qkv[2 * d + i]);
        }
      __syncthreads();
      TMARK(tm, PH_QKV);
      attend_part(rank, qkv, kc, vc, t + 1, d, p.nh, scores, lay.ls,
                  opart, part, lay.slot);
      cl.sync();
      TMARK(tm, PH_SELF);
      attend_combine(part, lay.slot, d, p.nh, xa + d, wts);
      float* const so = sm + lay.so;
      block_mv(p.wos + (size_t)blk * d * 2 * d, 2 * d, d, rank, xa,
               p.bos + (size_t)blk * d, so, false, pre);
      cl.sync();
      // x1 = LN(LN(so) + x)
      ln_chain(1, x1a, so, xa, g, bb, g + d, bb + d, d);
      __syncthreads();
      TMARK(tm, PH_SOUT);
      float* const q2 = sm + lay.q2;
      block_mv(p.wqc + (size_t)blk * d * d, d, d, rank, x1a,
               p.bqc + (size_t)blk * d, q2, false, pre);
      cl.sync();
      attend_part(rank, q2, p.ck + (size_t)blk * p.n_enc * d,
                  p.cv + (size_t)blk * p.n_enc * d, p.n_enc, d, p.nh, scores,
                  lay.ls, opart, part, lay.slot);
      cl.sync();
      TMARK(tm, PH_CROSS);
      attend_combine(part, lay.slot, d, p.nh, x1a + d, wts);
      const bool want_p = p.patience >= 0 && blk == p.nb - 1;
      float* const cand = sm + lay.cand;
      if (want_p && tid < 32) {
        // this block's rows of the head-summed attention: the largest, the
        // smallest row on ties, into slot `rank` of every block's cand
        const int nown = p.n_enc > rank ? (p.n_enc - 1 - rank) / C + 1 : 0;
        float best = -INFINITY;
        int arg = 0x7fffffff;
        for (int i = tid; i < nown; i += 32) {
          float s = 0.f;
          for (int h = 0; h < p.nh; ++h)
            s = fmaf(scores[h * lay.ls + i], wts[rank * p.nh + h], s);
          if (s > best) {
            best = s;
            arg = rank + C * i;
          }
        }
        etts::warp_argmax(best, arg);
        if (tid < C) {
          push(cand, 2 * rank, best, tid);
          push(cand, 2 * rank + 1, __int_as_float(arg), tid);
        }
      }
      float* const co = sm + lay.co;
      block_mv(p.woc + (size_t)blk * d * 2 * d, 2 * d, d, rank, x1a,
               p.boc + (size_t)blk * d, co, false, pre);
      cl.sync();
      if (want_p && tid == 0) {
        float best = -INFINITY;
        int arg = 0x7fffffff;
        for (int b = 0; b < C; ++b) {
          const float v = cand[2 * b];
          const int j = __float_as_int(cand[2 * b + 1]);
          if (v > best || (v == best && j < arg)) {
            best = v;
            arg = j;
          }
        }
        st[2] = arg >= p.n_enc - 2 ? st[2] + 1 : 0;
      }
      // x2 = LN(co + x1)
      float* const x2 = sm + lay.x2;
      ln_chain(0, x2, co, x1a, nullptr, nullptr, g + 2 * d, bb + 2 * d, d);
      __syncthreads();
      TMARK(tm, PH_COUT);
      float* const y1 = sm + lay.y1;
      block_mv(p.f1 + (size_t)blk * p.ffn * d, d, p.ffn, rank, x2,
               p.bf1 + (size_t)blk * p.ffn, y1, false, pre);
      cl.sync();
      float* const y2 = sm + lay.y2;
      block_mv(p.f2 + (size_t)blk * d * p.ffn, p.ffn, d, rank, y1,
               p.bf2 + (size_t)blk * d, y2, false, pre);
      cl.sync();
      // x = LN(x2 + relu(LN(y2)))
      ln_chain(2, xa, y2, x2, g + 3 * d, bb + 3 * d, g + 4 * d, bb + 4 * d, d);
      __syncthreads();
      TMARK(tm, PH_FFN);
    }
    // ---- final projection: r frames of mel, into history 0 ----
    block_mv(p.fpw, d, r * mel, rank, xa, p.fpb, mlin, false, pre);
    cl.sync();
    TMARK(tm, PH_FINAL);
    // ---- causal postnet over the r new frames ----
    for (int l = 0; l < p.npost; ++l) {
      const int in = l == 0 ? mel : cf;
      const bool last = l == p.npost - 1;
      const int on = last ? mel : cf;
      const float* hin = hist_of(l);
      float* hnext = last ? nullptr : hist_of(l + 1) + (k - 1) * cf;
      const __nv_bfloat16* W =
          l == 0 ? p.pc0
                 : last ? p.pcl : p.pcm + (size_t)(l - 1) * cf * k * cf;
      const int lo = row_lo(on, rank), hi = row_lo(on, rank + 1);
      for (int f0 = 0; f0 < r; f0 += MAXM)
        rows_mv<PG, MAXM>(
            W, k * in, lo, hi, hin + f0 * in, in, min(MAXM, r - f0),
            p.ps + (size_t)l * p.pw, p.psh + (size_t)l * p.pw,
            [&](int o, int m, float (&v)[PG], int lane) {
              const int f = f0 + m;
              if (!last) {
#pragma unroll
                for (int i = 0; i < PG; ++i) v[i] = tanhf(v[i]);
                push4(cl, hnext + f * cf + o, v, lane);
              } else {
#pragma unroll
                for (int i = 0; i < PG; ++i) {
                  v[i] = (mlin[f * mel + o + i] + v[i]) * __ldg(outs + o + i) +
                         __ldg(outb + o + i);
                  if (lane == i) out[((size_t)t * r + f) * mel + o + i] = v[i];
                }
                if (f == r - 1) push4(cl, frame + o, v, lane);
              }
            });
      if (!last) cl.sync();
    }
    TMARK(tm, PH_POST);
    // ---- stop head, guards (the same in every block), history slide ----
    __syncthreads();  // every warp is done reading the last layer's history
    {
      float* const slog = sm + lay.slog;
      const float* sw = sm + lay.stopw;
      for (int e = tid; e < 3 * r; e += NT) {  // one thread per frame, class
        const int f = e / 3, c = e % 3;
        float s = sw[3 * mel + c];
        for (int i = 0; i < mel; ++i)
          s = fmaf(sw[c * mel + i], mlin[f * mel + i], s);
        slog[e] = s;
      }
      // every layer's history slides by r frames, h[i] = h[i + r * in]: one
      // thread moves a residue class mod r * in in rising order, so it reads
      // each value before it overwrites it and no barrier is needed
      for (int l = 0; l < p.npost; ++l) {
        const int in = l == 0 ? mel : cf, sft = r * in, n = (k - 1) * in;
        float* h = hist_of(l);
        for (int q = tid; q < sft && q < n; q += NT)
          for (int i = q; i < n; i += sft) h[i] = h[i + sft];
      }
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
    }
    // publishes the fed-back frame and orders st for the loop test
    cl.sync();
    TMARK(tm, PH_STOP);
  }
  TEND(t_all, st[3]);
  // no block leaves while another may still address its shared memory
  cl.sync();
  if (rank == 0 && tid == 0) {
    p.len_out[0] = st[1];
    p.len_out[1] = st[3];
  }
}

}  // namespace

// The cluster size this library was built with.
extern "C" int decode_cluster_size() { return C; }

// ptrs: the 40 pointers of Params in declaration order; ints: t_max, r, d,
// nh, mel, P, ffn, n_enc, nb, k, npost, cf, pw, stop_index, stop_enabled,
// patience (-1 = off), frame_cap (-1 = off). Returns the CUDA error code,
// or -1 when no SM group of the card can hold the cluster.
extern "C" int decode_cluster_launch(void** ptrs, const int* ints, float rate,
                                     float start_value,
                                     unsigned long long seed, void* stream) {
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
  const size_t smem = (size_t)Layout(p).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (C > 8) {
    e = cudaFuncSetAttribute(decode_cluster,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, decode_cluster, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return -1;
  e = cudaLaunchKernelEx(&cfg, decode_cluster, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef ETTS_DECODE_TIMER
// Point the timer at a zeroed device buffer of NPHASE + 2 unsigned 64-bit
// counters; returns the CUDA error code.
extern "C" int decode_set_timer(void* buf) {
  return (int)cudaMemcpyToSymbol(g_timer, &buf, sizeof(buf));
}
#endif
