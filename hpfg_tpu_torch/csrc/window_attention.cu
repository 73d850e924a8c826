// Hand-written window multi-head attention kernels for the SwinUNet on
// Hopper.
//
// Replaces (hpfg_tpu/ops/pallas/window_attention.py):
//   * K13 _attn_kernel (_forward_call), launcher hpfg_window_attention_fwd:
//     per (window, head) o = (softmax(q k^T * D^-1/2 + bias[h] + mask[w])
//     * dropout mask) v, in fp32 inside, q/k/v/o in the compute type;
//   * K14 _attn_bwd_kernel (_backward_call), launcher
//     hpfg_window_attention_bwd: the softmax recomputed, then dq, dk, dv and
//     the per-CTA partials of dbias = sum over windows of ds. The TPU kernel
//     accumulates dbias in one output block across its sequential grid; here
//     each CTA sums its own windows in registers and writes one partial row,
//     and colsum_f32 (conv3x3.cu) adds the rows in a fixed order, so dbias is
//     bitwise the same from run to run.
//
// Layout: q, k and v are read straight from the packed qkv Dense output
// [Bn, L, 3C] (channel offsets 0, C, 2C, row stride 3C; head h is channels
// h*D .. h*D+D-1 of each), o and do are [Bn, L, C] and the backward writes
// dq, dk and dv into one [Bn, L, 3C] buffer, the gradient of qkv. bias is
// [H, L, L] fp32; mask is the per-image additive shift mask [nW, L, L] fp32
// (window w reads mask[w % nW]) or null for an unshifted block: the tiled
// [Bn, L, L] mask of the TPU entry is never built.
//
// What bounds them on an H100: per (window, head) a SwinUNet block at 224^2
// does 2 L^2 D multiply-adds in each product (L = 49, D = 32) on 2 L D
// values of q and k: about 50 FLOPs per byte of q, k, v and o in bf16, far
// below the 295 the tensor cores need, so the bound of the work is bytes
// (q, k, v read once, o written once: about 0.2 ms per 22-block forward at
// batch 32 at 3.35 TB/s). These first versions run the products on the fp32
// CUDA cores, one (window, head) per CTA in the forward, so they are bound by
// FMA issue and shared-memory loads instead, well above the byte bound.
//
// What the design does about it:
//   * one CTA stages one window's q (scaled), k and v of one head in shared
//     memory as fp32 rows padded to D+1 floats (conflict-free column reads),
//     the scores in an [L][L+1] tile: L = 49 never pads to 64, and no key
//     column beyond L is ever read, so no -inf padding is needed;
//   * scores, softmax and P v are three passes over the tile, the softmax one
//     warp per row with shuffle reductions, all in fp32 as the TPU kernel;
//   * the backward CTA walks a run of windows of one head (windows_per_cta,
//     chosen by the wrapper to keep about a thousand CTAs in flight) and
//     keeps its share of dbias in registers, so the partials are one row per
//     CTA, not one per window (59 MB per window at stage 0).
// No tensor cores (mma/wgmma) and no TMA yet: that is later work.
//
// Semantics follow the TPU kernels where bits matter:
//   * s = (q * scale) k^T, then + bias, then + mask, in that order; softmax
//     as exp(s - max) / sum; the dropout mask multiplies the probabilities,
//     so dv sees p * m and dp = m * (do v^T) before the softmax backward;
//   * the attention-dropout hash (hash.cuh) keys on b_idx = (w / blk) * 1024
//     + h and row = (w % blk) * L + i with lane j and row width L, where w is
//     the window index and blk = min(16, Bn), the TPU kernel's WINDOW_BLOCK:
//     derived from the window index, never from the CTA index;
//   * dq = (ds k) * scale and dk = ds^T (q * scale), as _attn_bwd_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;
constexpr int kMaxD = 64;
// score elements a thread owns in the backward's dbias accumulator
constexpr int kAcc = kMaxL * kMaxL / kThreads;

struct Drop {
  int on;
  uint32_t seed;
  uint32_t thresh;
  float scale;
};

template <typename T>
__device__ __forceinline__ float ld_f(const T* p);
template <>
__device__ __forceinline__ float ld_f<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void st_f(T* p, float v);
template <>
__device__ __forceinline__ void st_f<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void st_f<__nv_bfloat16>(__nv_bfloat16* p,
                                                    float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// one head's [L, D] slice of a token-major tensor with row stride ld, from
// window w at channel offset off, into a shared [L][D+1] tile times mul
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int w, int L,
                                      int D, int ld, int off, float mul) {
  for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
    const int i = idx / D, d = idx - (idx / D) * D;
    dst[i * (D + 1) + d] = ld_f(src + ((size_t)w * L + i) * ld + off + d) * mul;
  }
}

// scores s[i][j] = q[i] . k[j] + bias[i][j] (+ mask[i][j]) into sp
__device__ __forceinline__ void scores(float* sp, const float* sq,
                                       const float* sk, const float* bias_h,
                                       const float* mask_w, int L, int D) {
  for (int idx = threadIdx.x; idx < L * L; idx += kThreads) {
    const int i = idx / L, j = idx - (idx / L) * L;
    const float* qi = sq + i * (D + 1);
    const float* kj = sk + j * (D + 1);
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qi[d], kj[d], acc);
    float s = acc + bias_h[idx];
    if (mask_w) s = s + mask_w[idx];
    sp[i * (L + 1) + j] = s;
  }
}

// row softmax of sp in place, one warp per row
__device__ __forceinline__ void softmax_rows(float* sp, int L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < L; i += kWarps) {
    float* row = sp + i * (L + 1);
    float m = -3.4028235e38f;  // every score is finite
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) row[j] = row[j] / sum;
  }
}

// K13: grid (Bn, H), one window and one head per CTA
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask,
                    T* __restrict__ out, int L, int H, int D, float scale,
                    Drop drop, int blk) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const int C = H * D;
  float* sq = smem;
  float* sk = sq + L * (D + 1);
  float* sv = sk + L * (D + 1);
  float* sp = sv + L * (D + 1);

  stage(sq, qkv, w, L, D, 3 * C, h * D, scale);
  stage(sk, qkv, w, L, D, 3 * C, C + h * D, 1.f);
  stage(sv, qkv, w, L, D, 3 * C, 2 * C + h * D, 1.f);
  __syncthreads();
  const float* mask_w = mask ? mask + (size_t)(w % n_mask) * L * L : nullptr;
  scores(sp, sq, sk, bias + (size_t)h * L * L, mask_w, L, D);
  __syncthreads();
  softmax_rows(sp, L);
  __syncthreads();
  if (drop.on) {
    for (int idx = threadIdx.x; idx < L * L; idx += kThreads) {
      const int i = idx / L, j = idx - (idx / L) * L;
      sp[i * (L + 1) + j] *= hash_keep(drop.seed, drop.thresh, drop.scale,
                                       (w / blk) * 1024 + h,
                                       (w % blk) * L + i, L, j);
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
    const int i = idx / D, d = idx - (idx / D) * D;
    const float* pi = sp + i * (L + 1);
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(pi[j], sv[j * (D + 1) + d], acc);
    st_f(out + ((size_t)w * L + i) * C + h * D + d, acc);
  }
}

// K14: grid (ceil(Bn / windows_per_cta), H); one head, a run of windows
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask,
                    const T* __restrict__ dout, T* __restrict__ dqkv,
                    float* __restrict__ part, int Bn, int L, int H, int D,
                    float scale, Drop drop, int blk, int windows_per_cta) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  const int C = H * D;
  const int LL = L * L;
  float* sq = smem;
  float* sk = sq + L * (D + 1);
  float* sv = sk + L * (D + 1);
  float* sdo = sv + L * (D + 1);
  float* sp = sdo + L * (D + 1);   // p
  float* sdp = sp + L * (L + 1);   // dp, then ds
  float* sm = sdp + L * (L + 1);   // dropout multipliers
  float* srow = sm + L * (L + 1);  // sum_j dp * p per row
  const float* bias_h = bias + (size_t)h * LL;

  float acc[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc[t] = 0.f;

  const int w0 = blockIdx.x * windows_per_cta;
  const int w1 = min(w0 + windows_per_cta, Bn);
  for (int w = w0; w < w1; ++w) {
    stage(sq, qkv, w, L, D, 3 * C, h * D, scale);
    stage(sk, qkv, w, L, D, 3 * C, C + h * D, 1.f);
    stage(sv, qkv, w, L, D, 3 * C, 2 * C + h * D, 1.f);
    stage(sdo, dout, w, L, D, C, h * D, 1.f);
    __syncthreads();
    const float* mask_w = mask ? mask + (size_t)(w % n_mask) * LL : nullptr;
    scores(sp, sq, sk, bias_h, mask_w, L, D);
    __syncthreads();
    softmax_rows(sp, L);
    // dp[i][j] = (do[i] . v[j]) * m[i][j]
    for (int idx = threadIdx.x; idx < LL; idx += kThreads) {
      const int i = idx / L, j = idx - (idx / L) * L;
      const float* doi = sdo + i * (D + 1);
      const float* vj = sv + j * (D + 1);
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(doi[d], vj[d], a);
      float m = 1.f;
      if (drop.on)
        m = hash_keep(drop.seed, drop.thresh, drop.scale,
                      (w / blk) * 1024 + h, (w % blk) * L + i, L, j);
      sm[i * (L + 1) + j] = m;
      sdp[i * (L + 1) + j] = drop.on ? a * m : a;
    }
    __syncthreads();
    // dv[j][d] = sum_i p[i][j] m[i][j] do[i][d]
    for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
      const int j = idx / D, d = idx - (idx / D) * D;
      float a = 0.f;
      for (int i = 0; i < L; ++i) {
        const float pm = drop.on ? sp[i * (L + 1) + j] * sm[i * (L + 1) + j]
                                 : sp[i * (L + 1) + j];
        a = fmaf(pm, sdo[i * (D + 1) + d], a);
      }
      st_f(dqkv + ((size_t)w * L + j) * 3 * C + 2 * C + h * D + d, a);
    }
    // row sums r[i] = sum_j dp[i][j] p[i][j], one warp per row
    {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int i = warp; i < L; i += kWarps) {
        float r = 0.f;
        for (int j = lane; j < L; j += 32)
          r += sdp[i * (L + 1) + j] * sp[i * (L + 1) + j];
        r = warp_sum(r);
        if (lane == 0) srow[i] = r;
      }
    }
    __syncthreads();
    // ds = p (dp - r), in place of dp; this thread's dbias share
#pragma unroll
    for (int t = 0; t < kAcc; ++t) {
      const int idx = threadIdx.x + t * kThreads;
      if (idx < LL) {
        const int i = idx / L, j = idx - (idx / L) * L;
        const float p = sp[i * (L + 1) + j];
        const float ds = p * (sdp[i * (L + 1) + j] - srow[i]);
        sdp[i * (L + 1) + j] = ds;
        acc[t] += ds;
      }
    }
    __syncthreads();
    // dq[i][d] = scale * sum_j ds[i][j] k[j][d]
    for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
      const int i = idx / D, d = idx - (idx / D) * D;
      const float* dsi = sdp + i * (L + 1);
      float a = 0.f;
      for (int j = 0; j < L; ++j) a = fmaf(dsi[j], sk[j * (D + 1) + d], a);
      st_f(dqkv + ((size_t)w * L + i) * 3 * C + h * D + d, a * scale);
    }
    // dk[j][d] = sum_i ds[i][j] (q * scale)[i][d]
    for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
      const int j = idx / D, d = idx - (idx / D) * D;
      float a = 0.f;
      for (int i = 0; i < L; ++i)
        a = fmaf(sdp[i * (L + 1) + j], sq[i * (D + 1) + d], a);
      st_f(dqkv + ((size_t)w * L + j) * 3 * C + C + h * D + d, a);
    }
    __syncthreads();  // the next window overwrites the tiles
  }
  float* prow = part + ((size_t)blockIdx.x * H + h) * LL;
#pragma unroll
  for (int t = 0; t < kAcc; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    if (idx < LL) prow[idx] = acc[t];
  }
}

size_t fwd_smem(int L, int D) {
  return sizeof(float) * (3 * L * (D + 1) + L * (L + 1));
}

size_t bwd_smem(int L, int D) {
  return sizeof(float) * (4 * L * (D + 1) + 3 * L * (L + 1) + L);
}

template <typename T>
int launch_fwd(const void* qkv, const void* bias, const void* mask,
               int n_mask, void* out, int Bn, int L, int H, int D,
               float scale, Drop drop, int blk, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(attn_fwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)fwd_smem(kMaxL, kMaxD));
    opted_in = true;
  }
  attn_fwd_kernel<T><<<dim3(Bn, H), kThreads, fwd_smem(L, D), stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), n_mask, static_cast<T*>(out), L, H, D,
      scale, drop, blk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const void* bias, const void* mask,
               int n_mask, const void* dout, void* dqkv, void* part, int Bn,
               int L, int H, int D, float scale, Drop drop, int blk,
               int windows_per_cta, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(attn_bwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bwd_smem(kMaxL, kMaxD));
    opted_in = true;
  }
  const int ctas = (Bn + windows_per_cta - 1) / windows_per_cta;
  attn_bwd_kernel<T><<<dim3(ctas, H), kThreads, bwd_smem(L, D), stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), n_mask, static_cast<const T*>(dout),
      static_cast<T*>(dqkv), static_cast<float*>(part), Bn, L, H, D, scale,
      drop, blk, windows_per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hpfg_attn_max_l() { return kMaxL; }
int hpfg_attn_max_d() { return kMaxD; }

// K13. qkv [Bn, L, 3*H*D] and out [Bn, L, H*D] (bf16 when is_bf16, else
// fp32), bias [H, L, L] fp32, mask [n_mask, L, L] fp32 or null; blk is the
// hash's window block min(16, Bn).
int hpfg_window_attention_fwd(const void* qkv, const void* bias,
                              const void* mask, int n_mask, void* out, int Bn,
                              int L, int H, int D, float scale, int drop_on,
                              unsigned seed, unsigned thresh, float drop_scale,
                              int blk, int is_bf16, void* stream) {
  if (L > kMaxL || D > kMaxD) return (int)cudaErrorInvalidValue;
  Drop drop{drop_on, seed, thresh, drop_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16>(qkv, bias, mask, n_mask, out, Bn, L, H,
                                     D, scale, drop, blk, s);
  return launch_fwd<float>(qkv, bias, mask, n_mask, out, Bn, L, H, D, scale,
                           drop, blk, s);
}

// K14. As K13, plus dout [Bn, L, H*D], dqkv [Bn, L, 3*H*D] (the compute
// type) and part [ceil(Bn / windows_per_cta), H, L, L] fp32: one dbias
// partial per CTA, summed afterwards by hpfg_colsum_f32.
int hpfg_window_attention_bwd(const void* qkv, const void* bias,
                              const void* mask, int n_mask, const void* dout,
                              void* dqkv, void* part, int Bn, int L, int H,
                              int D, float scale, int drop_on, unsigned seed,
                              unsigned thresh, float drop_scale, int blk,
                              int windows_per_cta, int is_bf16,
                              void* stream) {
  if (L > kMaxL || D > kMaxD || windows_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  Drop drop{drop_on, seed, thresh, drop_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(qkv, bias, mask, n_mask, dout, dqkv,
                                     part, Bn, L, H, D, scale, drop, blk,
                                     windows_per_cta, s);
  return launch_bwd<float>(qkv, bias, mask, n_mask, dout, dqkv, part, Bn, L,
                           H, D, scale, drop, blk, windows_per_cta, s);
}

}  // extern "C"
