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
// The dtype picks the kernel (is_bf16): bf16, which every config trains in,
// runs attn_fwd_bf16_kernel / attn_bwd_bf16_kernel on the tensor cores;
// fp32 has no tensor-core product at fp32 precision, so it keeps the
// CUDA-core attn_fwd_kernel / attn_bwd_kernel.
//
// Layout: q, k and v are read straight from the packed qkv Dense output
// [Bn, L, 3C] (channel offsets 0, C, 2C, row stride 3C; head h is channels
// h*D .. h*D+D-1 of each), o and do are [Bn, L, C] and the backward writes
// dq, dk and dv into one [Bn, L, 3C] buffer, the gradient of qkv. bias is
// [H, L, L] fp32; mask is the per-image additive shift mask [nW, L, L] fp32
// (window w reads mask[w % nW]) or null for an unshifted block: the tiled
// [Bn, L, L] mask of the TPU entry is never built.
//
// The walk (ops/window_attention.py attention_walk): a CTA of the grid
// (ctas, H) takes one head h = blockIdx.y and a run of windows_per_cta
// windows of one mask class r = blockIdx.x % n_mask, w = r + n_mask * b for
// consecutive b, so every window of a CTA reads the same bias[h] and
// mask[r].
//
// What bounds them on an H100: per (window, head) a SwinUNet block at 224^2
// does 2 L^2 D FLOPs in each product (L = 49, D = 32: 154 KFLOP) on 9.4 KB
// of bf16 q, k and v: about 50 FLOPs per byte, far below the 295 the bf16
// tensor cores need, so the bound of the work is bytes (q, k, v (and do)
// read once, o (or dq, dk, dv) written once: 0.087 ms forward and 0.152 ms
// backward over the eight stage shapes of a step at batch 32). The ~50
// MMAs a warp issues per window are nothing; what sets the pace is getting
// each window's q, k, v in and its outputs out, and the per-element fp32
// work between the products (scale, bias, exp, the hash dropout: 32 score
// elements per thread and window).
//
// What the bf16 design does about it:
//   * q, k, v (and do) of the next window are copied by 16-byte cp.async
//     into the other half of a double buffer of bf16 [64][DP + 8] tiles
//     (DP = D padded to 16; the 16-byte row pad makes every ldmatrix
//     conflict-free) while the current window computes: one barrier a
//     window in the forward, two in the backward;
//   * each warp owns 16 query rows (L <= 64 = four warps' rows), so a whole
//     score row lives in one warp's registers: S = q k^T by mma.sync
//     m16n8k16 on the raw bf16 q and k, times scale in fp32, plus
//     bias + mask, row max and sum by quad shuffles, p = e * (1 / sum) and
//     the dropout multiply in fp32, then straight into P.V's A fragments
//     (the m16n8 accumulators of two n8 tiles are an m16k16 A fragment);
//     v enters as B through ldmatrix.trans;
//   * bias[h] + mask[r] of a thread's score fragments (32 fp32 values) are
//     read once per CTA and kept in registers for its whole run;
//   * the backward recomputes S and P, takes dP = do v^T, r = sum_j dP P and
//     dS = P (dP - r) in registers, adds the fp32 dS to the CTA's dbias
//     fragments, and takes dQ = dS k from dS as the A operand; dV = (P o
//     M)^T do and dK = dS^T q contract over the query rows, which four warps
//     share, so P o M and dS go to shared memory as bf16 and each warp
//     reads its 16 keys' columns back through ldmatrix.trans: no cross-warp
//     sum.
// Padding: rows i >= L and columns d >= D of every staged tile are zero
// (written once per CTA; cp.async never touches them), score columns
// j >= L are -inf before the max (so e = 0), and the backward zeroes P for
// rows i >= L, so no padded row or column reaches dV, dK or dbias, and none
// is stored. D that is not a multiple of 8 (or a pointer not 16-byte
// aligned) is staged and stored element by element instead of in 16-byte
// pieces; everything else is the same.
//
// Semantics follow the TPU kernels where bits matter:
//   * s = q k^T * scale + bias + mask, softmax as exp(s - max) / sum, then
//     the dropout mask multiplies the probabilities, so dv sees p * m and
//     dp = m * (do v^T) before the softmax backward. The bf16 kernels add
//     bias + mask as one fp32 term (bit for bit the same where the mask is
//     0; where it is -100 the probability underflows either way) and
//     normalise by one correctly rounded reciprocal a row (within an ulp of
//     e / sum, and exactly fl(1/L) for equal scores);
//   * rounding: K13 feeds P to P.V as two bf16 terms, p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), so P keeps about 16 bits and the output is
//     rounded once, at the store; K14 rounds P o M and dS to bf16 once, for
//     dV, dQ and dK, and sums dbias from the fp32 dS;
//   * the attention-dropout hash (hash.cuh) keys on b_idx = (w / blk) * 1024
//     + h and row = (w % blk) * L + i with lane j and row width L, where w is
//     the window index and blk = min(16, Bn), the TPU kernel's WINDOW_BLOCK:
//     derived from the window index and the fragment's (i, j), never from
//     the CTA index;
//   * dq = (ds k) * scale and dk = ds^T (q * scale), as _attn_bwd_kernel
//     (the bf16 kernels scale the fp32 sum of ds^T q).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;
constexpr int kMaxD = 64;
// score elements a thread owns in the fp32 backward's dbias accumulator
constexpr int kAcc = kMaxL * kMaxL / kThreads;

struct Drop {
  int on;
  uint32_t seed;
  uint32_t thresh;
  float scale;
};

// The windows of CTA x: w = r + n_mask * (b0 + t), t < n. The Python side
// (attention_walk) sizes the grid so that every CTA has n >= 1.
struct Walk {
  int r, b0, n, n_mask;
  __device__ Walk(int x, int Bn, int n_mask_, int windows_per_cta)
      : r(x % n_mask_),
        b0((x / n_mask_) * windows_per_cta),
        n(min(windows_per_cta, Bn / n_mask_ - b0)),
        n_mask(n_mask_) {}
  __device__ int window(int t) const { return r + n_mask * (b0 + t); }
};

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void stage(float* dst, const float* src, int w,
                                      int L, int D, int ld, int off,
                                      float mul) {
  for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
    const int i = idx / D, d = idx - (idx / D) * D;
    dst[i * (D + 1) + d] = src[((size_t)w * L + i) * ld + off + d] * mul;
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

// K13, fp32: grid (ctas, H); one head, a run of windows (Walk)
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask,
                    float* __restrict__ out, int Bn, int L, int H, int D,
                    float scale, Drop drop, int blk, int windows_per_cta) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  const int C = H * D;
  float* sq = smem;
  float* sk = sq + L * (D + 1);
  float* sv = sk + L * (D + 1);
  float* sp = sv + L * (D + 1);
  const Walk walk(blockIdx.x, Bn, n_mask, windows_per_cta);
  const float* mask_w = mask ? mask + (size_t)walk.r * L * L : nullptr;

  for (int t = 0; t < walk.n; ++t) {
    const int w = walk.window(t);
    stage(sq, qkv, w, L, D, 3 * C, h * D, scale);
    stage(sk, qkv, w, L, D, 3 * C, C + h * D, 1.f);
    stage(sv, qkv, w, L, D, 3 * C, 2 * C + h * D, 1.f);
    __syncthreads();
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
      out[((size_t)w * L + i) * C + h * D + d] = acc;
    }
    __syncthreads();  // the next window overwrites the tiles
  }
}

// K14, fp32: grid (ctas, H); one head, a run of windows (Walk)
__global__ void __launch_bounds__(kThreads)
    attn_bwd_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask,
                    const float* __restrict__ dout, float* __restrict__ dqkv,
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
  const Walk walk(blockIdx.x, Bn, n_mask, windows_per_cta);
  const float* mask_w = mask ? mask + (size_t)walk.r * LL : nullptr;

  float acc[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc[t] = 0.f;

  for (int t = 0; t < walk.n; ++t) {
    const int w = walk.window(t);
    stage(sq, qkv, w, L, D, 3 * C, h * D, scale);
    stage(sk, qkv, w, L, D, 3 * C, C + h * D, 1.f);
    stage(sv, qkv, w, L, D, 3 * C, 2 * C + h * D, 1.f);
    stage(sdo, dout, w, L, D, C, h * D, 1.f);
    __syncthreads();
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
      dqkv[((size_t)w * L + j) * 3 * C + 2 * C + h * D + d] = a;
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
      dqkv[((size_t)w * L + i) * 3 * C + h * D + d] = a * scale;
    }
    // dk[j][d] = sum_i ds[i][j] (q * scale)[i][d]
    for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
      const int j = idx / D, d = idx - (idx / D) * D;
      float a = 0.f;
      for (int i = 0; i < L; ++i)
        a = fmaf(sdp[i * (L + 1) + j], sq[i * (D + 1) + d], a);
      dqkv[((size_t)w * L + j) * 3 * C + C + h * D + d] = a;
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

// ---------------------------------------------------------------------------
// bf16: the tensor cores (mma.sync m16n8k16, fp32 sums)
// ---------------------------------------------------------------------------

constexpr int kRows = 64;         // tokens of a staged tile: four warps x 16
constexpr int kN8 = kRows / 8;    // n8 tiles of a score row
constexpr int kK16 = kRows / 16;  // k16 steps over the tokens
constexpr int kPRow = kRows + 8;  // row stride of the P o M and dS tiles

// A staged [kRows][ROW] bf16 tile of one head: D padded to DP = 16 * DT,
// rows padded by 16 bytes (an odd number of 16-byte groups: the eight rows
// of an ldmatrix phase fall on eight different bank groups)
template <int DT>
struct Tile {
  static constexpr int DP = 16 * DT;
  static constexpr int ROW = DP + 8;
  static constexpr int ELEMS = kRows * ROW;
};

// Zero rows i >= L and columns d >= D of n consecutive staged tiles, in
// 16-byte pieces (element by element where a piece straddles D).
template <int DT>
__device__ __forceinline__ void zero_pads(uint16_t* s, int n, int L, int D) {
  constexpr int PIECES = Tile<DT>::ROW / 8;
  for (int idx = threadIdx.x; idx < n * kRows * PIECES; idx += kThreads) {
    const int i = (idx / PIECES) % kRows, d = 8 * (idx % PIECES);
    uint16_t* p = s + 8 * idx;
    if (i >= L || d >= D)
      *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
    else
      for (int u = D - d; u < 8; ++u) p[u] = 0;
  }
}

// One head's [L, D] slice of window w of a token-major tensor (row stride
// ld, channel offset off) into a staged tile: 16-byte cp.async pieces when
// vec (D % 8 == 0, aligned), else element by element.
template <int DT>
__device__ __forceinline__ void stage_bf16(uint16_t* dst,
                                           const uint16_t* src, int w, int L,
                                           int D, int ld, int off, bool vec) {
  constexpr int ROW = Tile<DT>::ROW;
  const uint16_t* base = src + (size_t)w * L * ld + off;
  if (vec) {
    const int pieces = D / 8;
    for (int idx = threadIdx.x; idx < L * pieces; idx += kThreads) {
      const int i = idx / pieces, p = idx - i * pieces;
      cp_async16(dst + i * ROW + 8 * p, base + (size_t)i * ld + 8 * p, true);
    }
  } else {
    for (int idx = threadIdx.x; idx < L * D; idx += kThreads) {
      const int i = idx / D, d = idx - i * D;
      dst[i * ROW + d] = base[(size_t)i * ld + d];
    }
  }
}

// This thread's elements of the score fragments of its warp's 16 rows:
// element e of n8 tile t is row 16 warp + lane / 4 + 8 (e / 2), column
// 8 t + 2 (lane % 4) + e % 2 (the m16n8 accumulator layout).
__device__ __forceinline__ int frag_row(int e) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int t, int e) {
  return 8 * t + 2 * (threadIdx.x & 3) + (e & 1);
}

// bias[h] (+ mask[r]) at this thread's score fragments: -inf at a key
// column j >= L, 0 in a padded query row i >= L
__device__ __forceinline__ void load_bias_frag(float (&bm)[kN8][4],
                                               const float* bias_h,
                                               const float* mask_r, int L) {
#pragma unroll
  for (int t = 0; t < kN8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = frag_row(e), j = frag_col(t, e);
      float v = 0.f;
      if (j >= L) {
        v = -INFINITY;
      } else if (i < L) {
        v = bias_h[i * L + j];
        if (mask_r) v += mask_r[i * L + j];
      }
      bm[t][e] = v;
    }
}

// acc = a[this warp's 16 rows] . b^T over DP, every key column: S = q k^T,
// dP = do v^T (b's rows through ldmatrix, two n8 tiles an x4)
template <int DT>
__device__ __forceinline__ void rows_bt(float (&acc)[kN8][4],
                                        const uint16_t* sa,
                                        const uint16_t* sb) {
  constexpr int ROW = Tile<DT>::ROW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kN8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sa + (16 * warp + (lane & 15)) * ROW + 16 * kk +
                   8 * (lane >> 4));
#pragma unroll
    for (int t = 0; t < kN8; t += 2) {
      uint32_t b[4];
      ldsm_x4(b, sb + (8 * t + (lane & 7) + 8 * (lane >> 4)) * ROW +
                     16 * kk + 8 * ((lane >> 3) & 1));
      mma_bf16(acc[t], a, b[0], b[1]);
      mma_bf16(acc[t + 1], a, b[2], b[3]);
    }
  }
}

// The fp32 fragments of 16 rows x 64 columns as bf16 A fragments of the
// four k16 steps over those columns: a[0] rounded once, and with NT = 2
// a[1] the rounding error c - a[0], rounded (a[0] + a[1] keeps about 16
// bits of c)
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT][kK16][4],
                                     const float (&c)[kN8][4]) {
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v0 = c[2 * kk + (r >> 1)][2 * (r & 1)];
      const float v1 = c[2 * kk + (r >> 1)][2 * (r & 1) + 1];
      a[0][kk][r] = pack_bf16(v0, v1);
      if (NT == 2)
        a[1][kk][r] = pack_bf16(v0 - bf2f(a[0][kk][r] & 0xffffu),
                                v1 - bf2f(a[0][kk][r] >> 16));
    }
}

// acc += (sum of the NT terms of a) (16 x 64, A fragments) . b[64 tokens]
// [DP] (ldmatrix.trans): O = P v, dQ = dS k, and the transposed products
// below
template <int DT, int NT>
__device__ __forceinline__ void a_b(float (&acc)[2 * DT][4],
                                    const uint32_t (&a)[NT][kK16][4],
                                    const uint16_t* sb) {
  constexpr int ROW = Tile<DT>::ROW;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk)
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) {
      uint32_t b[4];
      ldsm_x4_t(b, sb + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * ROW +
                       16 * dd + 8 * (lane >> 4));
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        mma_bf16(acc[2 * dd], a[u][kk], b[0], b[1]);
        mma_bf16(acc[2 * dd + 1], a[u][kk], b[2], b[3]);
      }
    }
}

// acc = x^T[this warp's 16 keys][64 queries] . b[64 queries][DP], x a
// [query][key] tile of stride kPRow read transposed: dV = (P o M)^T do,
// dK = dS^T q
template <int DT>
__device__ __forceinline__ void xt_b(float (&acc)[2 * DT][4],
                                     const uint16_t* sx,
                                     const uint16_t* sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t a[1][kK16][4];
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk)
    ldsm_x4_t(a[0][kk],
              sx + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * kPRow +
                  16 * warp + 8 * ((lane >> 3) & 1));
#pragma unroll
  for (int dt = 0; dt < 2 * DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  a_b<DT>(acc, a, sb);
}

// (acc * mul) of this warp's 16 rows to rows i < L, columns d < D of a
// token-major bf16 tensor (row stride ld): bf16x2 words when vec
template <int DT>
__device__ __forceinline__ void store_rows(uint16_t* dst, int ld,
                                           const float (&acc)[2 * DT][4],
                                           int L, int D, float mul,
                                           bool vec) {
#pragma unroll
  for (int dt = 0; dt < 2 * DT; ++dt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = frag_row(2 * half), d = frag_col(dt, 0);
      if (i >= L || d >= D) continue;
      const float a = acc[dt][2 * half] * mul;
      const float b = acc[dt][2 * half + 1] * mul;
      uint16_t* p = dst + (size_t)i * ld + d;
      if (vec) {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
      } else {
        p[0] = f2bf(a);
        if (d + 1 < D) p[1] = f2bf(b);
      }
    }
}

// Scores of this warp's rows -> fp32 probabilities in place: s * scale + bm,
// row max and sum over the row's n8 tiles and the quad's four lanes,
// p = e * (1 / sum): one IEEE division a row. (A division per element takes
// its slow path wherever e is subnormal, as under the shift mask's -100,
// and doubled the time of a shifted call.)
__device__ __forceinline__ void softmax_frag(float (&s)[kN8][4],
                                             const float (&bm)[kN8][4],
                                             float scale) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kN8; ++t)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        s[t][e] = s[t][e] * scale + bm[t][e];
        m = fmaxf(m, s[t][e]);
      }
    m = fmaxf(m, __shfl_xor_sync(~0u, m, 1));
    m = fmaxf(m, __shfl_xor_sync(~0u, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kN8; ++t)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        s[t][e] = expf(s[t][e] - m);
        sum += s[t][e];
      }
    sum += __shfl_xor_sync(~0u, sum, 1);
    sum += __shfl_xor_sync(~0u, sum, 2);
    const float inv = 1.f / sum;
#pragma unroll
    for (int t = 0; t < kN8; ++t)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) s[t][e] *= inv;
  }
}

// The dropout multiplier of score (i, j) of window w: hash_keep keyed on
// b_idx = (w / blk) * 1024 + h and row (w % blk) * L + i.
struct DropKey {
  Drop drop;
  int b_idx, row0, L;
  __device__ DropKey(Drop d, int w, int h, int blk, int L_)
      : drop(d), b_idx((w / blk) * 1024 + h), row0((w % blk) * L_), L(L_) {}
  __device__ float operator()(int i, int j) const {
    return hash_keep(drop.seed, drop.thresh, drop.scale, b_idx, row0 + i, L,
                     j);
  }
};

// K13, bf16: grid (ctas, H); one head, a run of windows of one mask class.
// Shared memory: two buffers of the q, k, v tiles.
template <int DT>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_bf16_kernel(const uint16_t* __restrict__ qkv,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask, int n_mask,
                         uint16_t* __restrict__ out, int Bn, int L, int H,
                         int D, float scale, Drop drop, int blk,
                         int windows_per_cta, int vec) {
  extern __shared__ __align__(16) uint16_t attn_smem[];
  constexpr int TE = Tile<DT>::ELEMS;
  const int h = blockIdx.y, C = H * D, warp = threadIdx.x >> 5;
  const Walk walk(blockIdx.x, Bn, n_mask, windows_per_cta);

  zero_pads<DT>(attn_smem, 6, L, D);
  float bm[kN8][4];
  load_bias_frag(bm, bias + (size_t)h * L * L,
                 mask ? mask + (size_t)walk.r * L * L : nullptr, L);
  auto issue = [&](int t) {
    uint16_t* s = attn_smem + (t & 1) * 3 * TE;
    const int w = walk.window(t);
    for (int u = 0; u < 3; ++u)
      stage_bf16<DT>(s + u * TE, qkv, w, L, D, 3 * C, u * C + h * D, vec);
    cp_async_commit();
  };
  issue(0);
  for (int t = 0; t < walk.n; ++t) {
    const int w = walk.window(t);
    cp_async_wait0();
    // window t has landed everywhere, and every warp is done with window
    // t - 1, whose buffer the next copies fill
    __syncthreads();
    if (t + 1 < walk.n) issue(t + 1);
    if (16 * warp >= L) continue;
    const uint16_t* sq = attn_smem + (t & 1) * 3 * TE;
    float s[kN8][4];
    rows_bt<DT>(s, sq, sq + TE);
    softmax_frag(s, bm, scale);
    if (drop.on) {
      const DropKey m(drop, w, h, blk, L);
#pragma unroll
      for (int t8 = 0; t8 < kN8; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[t8][e] *= m(frag_row(e), frag_col(t8, e));
    }
    // P as p_hi + p_lo: rounding P to bf16 alone took the SwinUNet's eval
    // argmax agreement with the CPU's fp32 P below chip_smoke.py's 99%
    // gate; two terms keep about 16 bits of P at two MMAs per B fragment
    uint32_t pa[2][kK16][4];
    to_a(pa, s);
    float o[2 * DT][4];
#pragma unroll
    for (int dt = 0; dt < 2 * DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    a_b<DT>(o, pa, sq + 2 * TE);
    store_rows<DT>(out + (size_t)w * L * C + h * D, C, o, L, D, 1.f, vec);
  }
}

// K14, bf16: grid (ctas, H); one head, a run of windows of one mask class.
// Shared memory: two buffers of the q, k, v, do tiles, then the P o M and
// dS tiles [kRows][kPRow].
template <int DT>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_bf16_kernel(const uint16_t* __restrict__ qkv,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask, int n_mask,
                         const uint16_t* __restrict__ dout,
                         uint16_t* __restrict__ dqkv, float* __restrict__ part,
                         int Bn, int L, int H, int D, float scale, Drop drop,
                         int blk, int windows_per_cta, int vec) {
  extern __shared__ __align__(16) uint16_t attn_smem[];
  constexpr int TE = Tile<DT>::ELEMS;
  uint16_t* s_pm = attn_smem + 8 * TE;
  uint16_t* s_ds = s_pm + kRows * kPRow;
  const int h = blockIdx.y, C = H * D, LL = L * L, warp = threadIdx.x >> 5;
  const Walk walk(blockIdx.x, Bn, n_mask, windows_per_cta);

  zero_pads<DT>(attn_smem, 8, L, D);
  // rows of P o M and dS that no warp writes (a warp whose rows are all
  // >= L) stay zero
  for (int idx = threadIdx.x; idx < 2 * kRows * kPRow / 8; idx += kThreads)
    reinterpret_cast<uint4*>(s_pm)[idx] = make_uint4(0, 0, 0, 0);
  float bm[kN8][4], db[kN8][4];
  load_bias_frag(bm, bias + (size_t)h * LL,
                 mask ? mask + (size_t)walk.r * LL : nullptr, L);
#pragma unroll
  for (int t = 0; t < kN8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[t][e] = 0.f;
  auto issue = [&](int t) {
    uint16_t* s = attn_smem + (t & 1) * 4 * TE;
    const int w = walk.window(t);
    for (int u = 0; u < 3; ++u)
      stage_bf16<DT>(s + u * TE, qkv, w, L, D, 3 * C, u * C + h * D, vec);
    stage_bf16<DT>(s + 3 * TE, dout, w, L, D, C, h * D, vec);
    cp_async_commit();
  };
  issue(0);
  for (int t = 0; t < walk.n; ++t) {
    const int w = walk.window(t);
    cp_async_wait0();
    // window t has landed everywhere; every warp is done with window t - 1
    // (its buffer, P o M and dS)
    __syncthreads();
    if (t + 1 < walk.n) issue(t + 1);
    const uint16_t* sq = attn_smem + (t & 1) * 4 * TE;
    const uint16_t* sk = sq + TE;
    const uint16_t* sv = sk + TE;
    const uint16_t* sdo = sv + TE;
    uint16_t* gw = dqkv + (size_t)w * L * 3 * C + h * D;
    if (16 * warp < L) {
      float p[kN8][4], dp[kN8][4];
      rows_bt<DT>(p, sq, sk);
      softmax_frag(p, bm, scale);
      rows_bt<DT>(dp, sdo, sv);
      // P = 0 in padded rows; dP o M; P o M to shared memory (bf16);
      // r = sum_j dP P per row
      const DropKey mk(drop, w, h, blk, L);
      float r[2] = {0.f, 0.f};
#pragma unroll
      for (int t8 = 0; t8 < kN8; ++t8)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = frag_row(e), j = frag_col(t8, e);
          if (i >= L) p[t8][e] = p[t8][e + 1] = 0.f;
          float m0 = 1.f, m1 = 1.f;
          if (drop.on) {
            m0 = mk(i, j);
            m1 = mk(i, j + 1);
            dp[t8][e] *= m0;
            dp[t8][e + 1] *= m1;
          }
          *reinterpret_cast<uint32_t*>(s_pm + i * kPRow + j) =
              pack_bf16(p[t8][e] * m0, p[t8][e + 1] * m1);
          r[e >> 1] += dp[t8][e] * p[t8][e];
          r[e >> 1] += dp[t8][e + 1] * p[t8][e + 1];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        r[half] += __shfl_xor_sync(~0u, r[half], 1);
        r[half] += __shfl_xor_sync(~0u, r[half], 2);
      }
      // dS = P (dP - r) in place of dP, into dbias and shared memory (bf16)
#pragma unroll
      for (int t8 = 0; t8 < kN8; ++t8)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          dp[t8][e] = p[t8][e] * (dp[t8][e] - r[e >> 1]);
          dp[t8][e + 1] = p[t8][e + 1] * (dp[t8][e + 1] - r[e >> 1]);
          db[t8][e] += dp[t8][e];
          db[t8][e + 1] += dp[t8][e + 1];
          *reinterpret_cast<uint32_t*>(s_ds + frag_row(e) * kPRow +
                                       frag_col(t8, e)) =
              pack_bf16(dp[t8][e], dp[t8][e + 1]);
        }
      uint32_t dsa[1][kK16][4];
      to_a(dsa, dp);
      float dq[2 * DT][4];
#pragma unroll
      for (int dt = 0; dt < 2 * DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
      a_b<DT>(dq, dsa, sk);
      store_rows<DT>(gw, 3 * C, dq, L, D, scale, vec);
    }
    __syncthreads();  // P o M and dS are complete
    if (16 * warp < L) {  // this warp's 16 keys
      float g[2 * DT][4];
      xt_b<DT>(g, s_pm, sdo);
      store_rows<DT>(gw + 2 * C, 3 * C, g, L, D, 1.f, vec);
      xt_b<DT>(g, s_ds, sq);
      store_rows<DT>(gw + C, 3 * C, g, L, D, scale, vec);
    }
  }
  float* prow = part + ((size_t)blockIdx.x * H + h) * LL;
#pragma unroll
  for (int t8 = 0; t8 < kN8; ++t8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = frag_row(e), j = frag_col(t8, e);
      if (i < L && j < L) prow[i * L + j] = db[t8][e];
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

size_t fwd_smem(int L, int D) {
  return sizeof(float) * (3 * L * (D + 1) + L * (L + 1));
}

size_t bwd_smem(int L, int D) {
  return sizeof(float) * (4 * L * (D + 1) + 3 * L * (L + 1) + L);
}

template <int DT>
size_t fwd_bf16_smem() {
  return sizeof(uint16_t) * 6 * Tile<DT>::ELEMS;
}

template <int DT>
size_t bwd_bf16_smem() {
  return sizeof(uint16_t) * (8 * Tile<DT>::ELEMS + 2 * kRows * kPRow);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Raise a kernel's dynamic shared-memory cap once per process.
template <typename K>
void opt_in(K kernel, size_t bytes, bool& done) {
  if (!done) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    done = true;
  }
}

template <int DT>
void launch_fwd_bf16(dim3 grid, const void* qkv, const void* bias,
                     const void* mask, int n_mask, void* out, int Bn, int L,
                     int H, int D, float scale, Drop drop, int blk,
                     int windows_per_cta, cudaStream_t stream) {
  static bool opted_in = false;
  opt_in(attn_fwd_bf16_kernel<DT>, fwd_bf16_smem<DT>(), opted_in);
  const int vec = D % 8 == 0 && aligned16(qkv) && aligned16(out);
  attn_fwd_bf16_kernel<DT><<<grid, kThreads, fwd_bf16_smem<DT>(), stream>>>(
      static_cast<const uint16_t*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), n_mask, static_cast<uint16_t*>(out),
      Bn, L, H, D, scale, drop, blk, windows_per_cta, vec);
}

template <int DT>
void launch_bwd_bf16(dim3 grid, const void* qkv, const void* bias,
                     const void* mask, int n_mask, const void* dout,
                     void* dqkv, void* part, int Bn, int L, int H, int D,
                     float scale, Drop drop, int blk, int windows_per_cta,
                     cudaStream_t stream) {
  static bool opted_in = false;
  opt_in(attn_bwd_bf16_kernel<DT>, bwd_bf16_smem<DT>(), opted_in);
  const int vec =
      D % 8 == 0 && aligned16(qkv) && aligned16(dout) && aligned16(dqkv);
  attn_bwd_bf16_kernel<DT><<<grid, kThreads, bwd_bf16_smem<DT>(), stream>>>(
      static_cast<const uint16_t*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), n_mask,
      static_cast<const uint16_t*>(dout), static_cast<uint16_t*>(dqkv),
      static_cast<float*>(part), Bn, L, H, D, scale, drop, blk,
      windows_per_cta, vec);
}

}  // namespace

extern "C" {

int hpfg_attn_max_l() { return kMaxL; }
int hpfg_attn_max_d() { return kMaxD; }

// K13. qkv [Bn, L, 3*H*D] and out [Bn, L, H*D] (bf16 when is_bf16, else
// fp32), bias [H, L, L] fp32, mask [n_mask, L, L] fp32 or null (n_mask 1);
// blk is the hash's window block min(16, Bn); the grid is (ctas, H), each
// CTA walking windows_per_cta windows (attention_walk).
int hpfg_window_attention_fwd(const void* qkv, const void* bias,
                              const void* mask, int n_mask, void* out, int Bn,
                              int L, int H, int D, float scale, int drop_on,
                              unsigned seed, unsigned thresh, float drop_scale,
                              int blk, int windows_per_cta, int ctas,
                              int is_bf16, void* stream) {
  if (L > kMaxL || D > kMaxD || windows_per_cta < 1 || Bn % n_mask)
    return (int)cudaErrorInvalidValue;
  Drop drop{drop_on, seed, thresh, drop_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ctas, H);
  if (!is_bf16) {
    static bool opted_in = false;
    opt_in(attn_fwd_kernel, fwd_smem(kMaxL, kMaxD), opted_in);
    attn_fwd_kernel<<<grid, kThreads, fwd_smem(L, D), s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), n_mask, static_cast<float*>(out), Bn,
        L, H, D, scale, drop, blk, windows_per_cta);
    return (int)cudaGetLastError();
  }
  constexpr decltype(&launch_fwd_bf16<1>) by_dt[] = {
      launch_fwd_bf16<1>, launch_fwd_bf16<2>, launch_fwd_bf16<3>,
      launch_fwd_bf16<4>};
  by_dt[(D + 15) / 16 - 1](grid, qkv, bias, mask, n_mask, out, Bn, L, H, D,
                           scale, drop, blk, windows_per_cta, s);
  return (int)cudaGetLastError();
}

// K14. As K13, plus dout [Bn, L, H*D], dqkv [Bn, L, 3*H*D] (the compute
// type) and part [ctas, H, L, L] fp32: one dbias partial per CTA, summed
// afterwards by hpfg_colsum_f32.
int hpfg_window_attention_bwd(const void* qkv, const void* bias,
                              const void* mask, int n_mask, const void* dout,
                              void* dqkv, void* part, int Bn, int L, int H,
                              int D, float scale, int drop_on, unsigned seed,
                              unsigned thresh, float drop_scale, int blk,
                              int windows_per_cta, int ctas, int is_bf16,
                              void* stream) {
  if (L > kMaxL || D > kMaxD || windows_per_cta < 1 || Bn % n_mask)
    return (int)cudaErrorInvalidValue;
  Drop drop{drop_on, seed, thresh, drop_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ctas, H);
  if (!is_bf16) {
    static bool opted_in = false;
    opt_in(attn_bwd_kernel, bwd_smem(kMaxL, kMaxD), opted_in);
    attn_bwd_kernel<<<grid, kThreads, bwd_smem(L, D), s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), n_mask,
        static_cast<const float*>(dout), static_cast<float*>(dqkv),
        static_cast<float*>(part), Bn, L, H, D, scale, drop, blk,
        windows_per_cta);
    return (int)cudaGetLastError();
  }
  constexpr decltype(&launch_bwd_bf16<1>) by_dt[] = {
      launch_bwd_bf16<1>, launch_bwd_bf16<2>, launch_bwd_bf16<3>,
      launch_bwd_bf16<4>};
  by_dt[(D + 15) / 16 - 1](grid, qkv, bias, mask, n_mask, dout, dqkv, part,
                           Bn, L, H, D, scale, drop, blk, windows_per_cta, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
