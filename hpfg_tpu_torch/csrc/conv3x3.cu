// Hand-written 3x3 SAME convolution kernels for the UNet ConvBlock on Hopper.
//
// Replaces (hpfg_tpu/ops/pallas/conv_block.py):
//   * conv3x3_kernel, one source, with the launcher hpfg_conv3x3_nhwc:
//       - kernel A: _conv_stats_kernel (K1), _bn_act_conv_stats_kernel (K2)
//         and _dgrad_kernel (K6); the C=1 stem, which _conv_stats_c1_kernel
//         (K12) serves on the TPU, is the C=1 case of the same kernel;
//       - K11 _dgrad_reduce_kernel: A in dgrad form (flipped weights, output
//         dropout mask) with the reduce epilogue (Reduce below) that takes the
//         next stage's BN-backward sums [sum dz, sum dz*xhat] from its own
//         rounded output rows, so that pass never reads them back from HBM;
//   * the same kernel with two sources or two outputs:
//       - K8 _conv_stats_cat_kernel: the UpBlock conv1 over the implicit
//         channel concat (skip || up): channel c < C1 is read from x, the rest
//         from x2. The concat is never written;
//       - K9 _dgrad_pair_kernel: the UpBlock conv1 dgrad; output channel
//         n < F1 goes to y (dx_skip), the rest to y2 (dx_up), each a
//         contiguous NHWC tensor for its own consumer;
//   * wgrad_kernel (hpfg_conv3x3_wgrad_nhwc): kernel B, _wgrad_kernel (K7)
//     with its _fold_wgrad, and with two sources K10 _wgrad_pair_kernel: one
//     launch over the concatenated channel range whose per-block partial row
//     holds [3,3,C1,F] then [3,3,C-C1,F];
//   * colsum_f32: the cross-grid accumulation the TPU kernels do in a
//     revisited output block (_flush_stats and the wgrad accumulator):
//     per-CTA partials are summed here in a fixed order, so runs are
//     deterministic.
//
// What bounds these kernels on an H100: the convolutions of the UNet have
// 1..256 input and 4..256 output channels; the 224^2 and 112^2 stages have
// few channels and many pixels, the 14^2 and 28^2 stages the reverse. Every
// stage does about the same number of FLOPs (an UpBlock conv1 is 14.8 GFLOP
// at batch 32 at every stage). The bound of the work itself is the larger of
// bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s (bf16 tensor cores): memory at
// 224^2 (up4.conv1: 154 MB, 46 us), operations at 28^2 (up1.conv1: 15 us).
// These first versions run on the CUDA cores in fp32 (67 TFLOP/s peak), so
// they are bound by FMA issue and by shared-memory loads, far above either.
// The pair and reduce forms add no HBM pass: K8 reads each half once, K9
// writes each half once, K11's reduce reads the residual h once and writes
// one [sum, sum^2]-sized partial per block.
//
// What the design does about it:
//   * a block stages one 8x16-pixel tile (plus its 1-pixel halo) of 16 input
//     channels in shared memory, already transformed by the prologue
//     (BN affine + LeakyReLU + hash dropout) and rounded to the compute type,
//     so each input value is loaded from HBM and transformed once per output
//     channel tile instead of nine times; for a pair, each staged channel
//     picks its source, so a split that is not a multiple of the 16-channel
//     tile stages both halves into one tile;
//   * each thread keeps 4 pixels x 4 output channels in registers and reads
//     one 6-value input row per (channel, dy), reused by the three dx taps:
//     48 FMAs per 9 shared-memory loads;
//   * the BN statistics (or K11's reduce terms) are reduced in registers and
//     warp shuffles and leave the block as one [s0, s1] partial per channel.
// No tensor cores (wgmma), TMA or pipelining yet: that is later work.
//
// Semantics follow the Pallas kernels exactly where bits matter:
//   * the prologue runs in fp32 on in-image pixels only; SAME padding is
//     zeros of the transformed input (conv_block.py _padded_rows);
//   * conv operands are rounded to the compute dtype after the prologue, and
//     products accumulate in fp32 (conv_block.py _conv_rows);
//   * bias is added and the statistics are taken on the fp32 result, before
//     the store rounds it; K11's reduce is taken on the ROUNDED output, as
//     _dgrad_reduce_kernel casts before its reduce, so its sums equal those
//     of a separate reduce over the stored tensor;
//   * a*x+b is rounded as a multiply and then an add (no FMA), in the
//     prologue and in K11's LeakyReLU-derivative test, as the plain versions
//     compute it;
//   * the dropout mask is the murmur3-style hash of (seed, image, row, lane)
//     with lane = x*C + c (conv_block.py _hash_mask); the image index is the
//     batch index of the pixel, never a block index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSlope = 0.01f;
constexpr int TH = 8;    // tile rows
constexpr int TW = 16;   // tile columns
constexpr int CC = 16;   // input channels staged per pass
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;
constexpr int PLANE = HALO_PIX + 1;  // odd stride: conflict-free channel planes

struct Prologue {
  const float* a;  // [C] BN scale folded with inv-std; null: identity source
  const float* b;  // [C]
  int has_mask;
  uint32_t seed;
  uint32_t thresh;
  float scale;
};

struct OutMask {
  int has_mask;
  uint32_t seed;
  uint32_t thresh;
  float scale;
};

// K11's epilogue: the next stage's train-BN backward reduce of the rounded
// output o against its pre-activation residual pre [B,H,W,F]:
//   dz = o * lrelu'(a*pre + b), xhat = (pre - m) * inv,
//   s0 += dz, s1 += dz * xhat.
// pre == null: the epilogue takes BN statistics [o, o^2] instead.
template <typename T>
struct Reduce {
  const T* pre;
  const float* a;
  const float* b;
  const float* m;
  const float* inv;
};

__device__ __forceinline__ float hash_keep(uint32_t seed, uint32_t thresh,
                                           float scale, int image, int row,
                                           int lanes, int lane) {
  uint32_t v = (uint32_t)(row * lanes + lane);
  uint32_t x = v + (seed + (uint32_t)image * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < thresh ? scale : 0.f;
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One conv operand: source pixel (y, x) of image b, channel c of a tensor
// with C channels, after the prologue, rounded to T; zero outside the image.
template <typename T>
__device__ __forceinline__ float source_val(const T* __restrict__ src,
                                            const Prologue& pro, int b, int y,
                                            int x, int c, int H, int W,
                                            int C) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.f;
  float v = to_f<T>(src[(((size_t)b * H + y) * W + x) * C + c]);
  if (pro.a != nullptr) {
    // multiply and add rounded separately (no FMA), as the plain version
    // computes them, so both take the same LeakyReLU branch
    v = __fadd_rn(__fmul_rn(v, pro.a[c]), pro.b[c]);
    v = v >= 0.f ? v : v * kSlope;
    if (pro.has_mask)
      v *= hash_keep(pro.seed, pro.thresh, pro.scale, b, y, W * C, x * C + c);
  }
  return to_f<T>(from_f<T>(v));
}

// Stage the transformed halo tile of channels [c0, c0+CC) into s_in.
// Channels c < C1 come from src ([B,H,W,C1]), the rest from src2
// ([B,H,W,C-C1], a pair's second half; the prologue is identity then).
template <typename T, int NT>
__device__ __forceinline__ void stage_halo(float* s_in,
                                           const T* __restrict__ src,
                                           const T* __restrict__ src2, int C1,
                                           const Prologue& pro, int b, int ty0,
                                           int tx0, int c0, int H, int W,
                                           int C) {
  for (int i = threadIdx.x; i < CC * HALO_PIX; i += NT) {
    int cc = i % CC;
    int rc = i / CC;
    int r = rc / HALO_W;
    int col = rc - r * HALO_W;
    const int c = c0 + cc;
    float v = 0.f;
    if (c < C1)
      v = source_val<T>(src, pro, b, ty0 + r - 1, tx0 + col - 1, c, H, W, C1);
    else if (c < C)
      v = source_val<T>(src2, pro, b, ty0 + r - 1, tx0 + col - 1, c - C1, H,
                        W, C - C1);
    s_in[cc * PLANE + rc] = v;
  }
}

// y[b, oy, ox, n] = bias[n] + sum_{ky,kx,c} src'[b, oy+ky-1, ox+kx-1, c]
//                                          * w[ky, kx, c, n]
// src' is x (channels < C1) || x2; output channels < F1 go to y
// ([B,H,W,F1]), the rest to y2 ([B,H,W,F-F1]).
// Grid: (spatial tiles, ceil(F/BN), B). Block: 32 * BN/4 threads; warp tn
// owns output channels [n0 + 4tn, n0 + 4tn + 4) of all 32 pixel groups.
template <typename T, int BN>
__global__ void __launch_bounds__(32 * (BN / 4))
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ x2, int C1,
               const T* __restrict__ w, const float* __restrict__ bias,
               Prologue pro, OutMask om, Reduce<T> red, T* __restrict__ y,
               T* __restrict__ y2, int F1, float* __restrict__ part, int H,
               int W, int C, int F, int tiles_x) {
  constexpr int NT = 32 * (BN / 4);
  __shared__ float s_in[CC * PLANE];
  __shared__ __align__(16) float s_w[9 * CC * BN];

  const int tid = threadIdx.x;
  const int g = tid & 31;
  const int tn = tid >> 5;
  const int pr = g >> 2;        // tile row of this thread's 4 pixels
  const int pc = (g & 3) * 4;   // first tile column
  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int ccn = min(CC, C - c0);
    stage_halo<T, NT>(s_in, x, x2, C1, pro, b, ty0, tx0, c0, H, W, C);
    for (int i = tid; i < 9 * CC * BN; i += NT) {
      int nn = i % BN;
      int rest = i / BN;
      int cc = rest % CC;
      int tap = rest / CC;
      int n = n0 + nn;
      float v = 0.f;
      if (cc < ccn && n < F) v = to_f<T>(w[((size_t)tap * C + c0 + cc) * F + n]);
      s_w[i] = v;
    }
    __syncthreads();
    for (int cc = 0; cc < ccn; ++cc) {
      const float* sp = s_in + cc * PLANE + pr * HALO_W + pc;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float row[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) row[q] = sp[ky * HALO_W + q];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              s_w + ((ky * 3 + kx) * CC + cc) * BN + tn * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = row[i + kx];
            acc[i][0] += a * wv.x;
            acc[i][1] += a * wv.y;
            acc[i][2] += a * wv.z;
            acc[i][3] += a * wv.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = ty0 + pr;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float q2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ox = tx0 + pc + i;
    if (oy >= H || ox >= W) continue;
    const size_t pix = ((size_t)b * H + oy) * W + ox;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n >= F) continue;
      float o = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
      if (om.has_mask)
        o *= hash_keep(om.seed, om.thresh, om.scale, b, oy, W * F, ox * F + n);
      const T ot = from_f<T>(o);
      if (red.pre != nullptr) {
        const float orr = to_f<T>(ot);
        const float p = to_f<T>(red.pre[pix * F + n]);
        const float z = __fadd_rn(__fmul_rn(p, red.a[n]), red.b[n]);
        const float dz = z >= 0.f ? orr : orr * kSlope;
        const float xhat = (p - red.m[n]) * red.inv[n];
        s[j] += dz;
        q2[j] += dz * xhat;
      } else {
        s[j] += o;
        q2[j] += o * o;
      }
      if (n < F1)
        y[pix * F1 + n] = ot;
      else
        y2[pix * (F - F1) + (n - F1)] = ot;
    }
  }
  if (part != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        q2[j] += __shfl_xor_sync(0xffffffffu, q2[j], off);
      }
    }
    if (g == 0) {
      const size_t prow = (size_t)b * gridDim.x + blockIdx.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tn * 4 + j;
        if (n < F) {
          part[prow * 2 * F + n] = s[j];
          part[prow * 2 * F + F + n] = q2[j];
        }
      }
    }
  }
}

// dW partial for one block: sum over its spatial tiles of
//   src'[b, y+ky-1, x+kx-1, c] * dp[b, y, x, n]
// with src' = src (channels < C1) || src2 as in conv3x3_kernel.
// Grid: (row blocks, ceil(C/CC), ceil(F/BN)). Block: CC * BN/4 threads;
// thread (c, tq) keeps the 9 taps x 4 output channels of input channel c.
// part: [gridDim.x, 9*C*F], each row [3,3,C1,F] then [3,3,C-C1,F], summed by
// colsum afterwards.
template <typename T, int BN>
__global__ void __launch_bounds__(CC * (BN / 4))
wgrad_kernel(const T* __restrict__ src, const T* __restrict__ src2, int C1,
             const T* __restrict__ dp, Prologue pro,
             float* __restrict__ part, int H, int W, int C, int F,
             int tiles_x, int tiles_per_img, int total_tiles,
             int tiles_per_block) {
  constexpr int NT = CC * (BN / 4);
  __shared__ float s_in[CC * PLANE];
  __shared__ __align__(16) float s_dp[TH * TW * BN];

  const int tid = threadIdx.x;
  const int c = tid % CC;
  const int tq = tid / CC;
  const int c0 = blockIdx.y * CC;
  const int n0 = blockIdx.z * BN;

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;

  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, total_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const int b = t / tiles_per_img;
    const int tt = t - b * tiles_per_img;
    const int ty0 = (tt / tiles_x) * TH;
    const int tx0 = (tt % tiles_x) * TW;
    stage_halo<T, NT>(s_in, src, src2, C1, pro, b, ty0, tx0, c0, H, W, C);
    for (int i = tid; i < TH * TW * BN; i += NT) {
      int nn = i % BN;
      int p = i / BN;
      int yy = ty0 + p / TW;
      int xx = tx0 + p % TW;
      int n = n0 + nn;
      float v = 0.f;
      if (yy < H && xx < W && n < F)
        v = to_f<T>(dp[(((size_t)b * H + yy) * W + xx) * F + n]);
      s_dp[i] = v;
    }
    __syncthreads();
    if (c0 + c < C) {
      for (int r = 0; r < TH; ++r) {
        const float* sp = s_in + c * PLANE + r * HALO_W;
        float win[3][3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          win[ky][0] = sp[ky * HALO_W];
          win[ky][1] = sp[ky * HALO_W + 1];
        }
#pragma unroll
        for (int xx = 0; xx < TW; ++xx) {
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) win[ky][2] = sp[ky * HALO_W + xx + 2];
          const float4 d = *reinterpret_cast<const float4*>(
              s_dp + (r * TW + xx) * BN + tq * 4);
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float a = win[ky][kx];
              acc[ky * 3 + kx][0] += a * d.x;
              acc[ky * 3 + kx][1] += a * d.y;
              acc[ky * 3 + kx][2] += a * d.z;
              acc[ky * 3 + kx][3] += a * d.w;
            }
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            win[ky][0] = win[ky][1];
            win[ky][1] = win[ky][2];
          }
        }
      }
    }
    __syncthreads();
  }
  const int cg = c0 + c;
  if (cg < C) {
    // this channel's half: [3,3,C1,F] at the row's start, else [3,3,C-C1,F]
    // after it
    const int ch = cg < C1 ? C1 : C - C1;
    const int ci = cg < C1 ? cg : cg - C1;
    float* out = part + (size_t)blockIdx.x * 9 * C * F +
                 (cg < C1 ? 0 : (size_t)9 * C1 * F);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tq * 4 + j;
        if (n < F) out[((size_t)tap * ch + ci) * F + n] = acc[tap][j];
      }
  }
}

// out[blockIdx.y, n] = sum of in[r, n] over rows r of this block's row
// range, in a fixed order. Block (32, 8).
__global__ void colsum_kernel(const float* __restrict__ in,
                              float* __restrict__ out, int R, int N,
                              int rows_per_block) {
  __shared__ float red[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);
  float s = 0.f;
  if (col < N)
    for (int r = r0 + threadIdx.y; r < r1; r += 8) s += in[(size_t)r * N + col];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < N) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][threadIdx.x];
    out[(size_t)blockIdx.y * N + col] = t;
  }
}

struct ConvArgs {
  const void* x;
  const void* x2;
  int c1;
  const void* w;
  const void* bias;
  Prologue pro;
  OutMask om;
  const void* pre;
  const float* ra;
  const float* rb;
  const float* rm;
  const float* rinv;
  void* y;
  void* y2;
  int f1;
  void* part;
};

template <typename T, int BN>
void launch_conv(const ConvArgs& a, int B, int H, int W, int C, int F,
                 cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, (F + BN - 1) / BN, B);
  Reduce<T> red{static_cast<const T*>(a.pre), a.ra, a.rb, a.rm, a.rinv};
  conv3x3_kernel<T, BN><<<grid, 32 * (BN / 4), 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.x2), a.c1,
      static_cast<const T*>(a.w), static_cast<const float*>(a.bias), a.pro,
      a.om, red, static_cast<T*>(a.y), static_cast<T*>(a.y2), a.f1,
      static_cast<float*>(a.part), H, W, C, F, tiles_x);
}

template <typename T, int BN>
void launch_wgrad(const void* src, const void* src2, int c1, const void* dp,
                  const Prologue& pro, void* part, int B, int H, int W, int C,
                  int F, int tiles_per_block, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + TH - 1) / TH);
  const int total = B * tiles_per_img;
  dim3 grid((total + tiles_per_block - 1) / tiles_per_block,
            (C + CC - 1) / CC, (F + BN - 1) / BN);
  wgrad_kernel<T, BN><<<grid, CC * (BN / 4), 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(src2), c1,
      static_cast<const T*>(dp), pro, static_cast<float*>(part), H, W, C, F,
      tiles_x, tiles_per_img, total, tiles_per_block);
}

}  // namespace

extern "C" {

int hpfg_tile_h() { return TH; }
int hpfg_tile_w() { return TW; }

// One launch of conv3x3_kernel; every kernel-A form goes through here.
// x [B,H,W,c1] and x2 [B,H,W,C-c1] (null unless a pair; c1 = C then), w
// [3,3,C,F] (all bf16 when is_bf16, else fp32), bias [F] fp32 or null,
// pa/pb [C] fp32 or null (identity source), y [B,H,W,f1] and y2
// [B,H,W,F-f1] (null unless a split output; f1 = F then), part
// [B*tiles, 2, F] fp32 or null (no epilogue sums); pre [B,H,W,F] of x's type
// plus ra/rb/rm/rinv [F] fp32 select the reduce epilogue (else null).
int hpfg_conv3x3_nhwc(const void* x, const void* x2, int c1, const void* w,
                      const void* bias, const void* pa, const void* pb,
                      int in_mask, unsigned in_seed, unsigned in_thresh,
                      float in_scale, int out_mask, unsigned out_seed,
                      unsigned out_thresh, float out_scale, const void* pre,
                      const void* ra, const void* rb, const void* rm,
                      const void* rinv, void* y, void* y2, int f1, void* part,
                      int B, int H, int W, int C, int F, int is_bf16,
                      void* stream) {
  ConvArgs a{x, x2, c1, w, bias,
             Prologue{static_cast<const float*>(pa),
                      static_cast<const float*>(pb), in_mask, in_seed,
                      in_thresh, in_scale},
             OutMask{out_mask, out_seed, out_thresh, out_scale},
             pre, static_cast<const float*>(ra), static_cast<const float*>(rb),
             static_cast<const float*>(rm), static_cast<const float*>(rinv),
             y, y2, f1, part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (F <= 16)
      launch_conv<__nv_bfloat16, 16>(a, B, H, W, C, F, s);
    else
      launch_conv<__nv_bfloat16, 32>(a, B, H, W, C, F, s);
  } else {
    if (F <= 16)
      launch_conv<float, 16>(a, B, H, W, C, F, s);
    else
      launch_conv<float, 32>(a, B, H, W, C, F, s);
  }
  return (int)cudaGetLastError();
}

// src [B,H,W,c1] and src2 [B,H,W,C-c1] (null unless a pair; c1 = C then),
// dp [B,H,W,F]; part [rows, 9*C*F] fp32 with
// rows = ceil(B*tiles / tiles_per_block).
int hpfg_conv3x3_wgrad_nhwc(const void* src, const void* src2, int c1,
                            const void* dp, const void* pa, const void* pb,
                            int in_mask, unsigned seed, unsigned thresh,
                            float scale, void* part, int B, int H, int W,
                            int C, int F, int tiles_per_block, int is_bf16,
                            void* stream) {
  Prologue pro{static_cast<const float*>(pa), static_cast<const float*>(pb),
               in_mask, seed, thresh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (F <= 16)
      launch_wgrad<__nv_bfloat16, 16>(src, src2, c1, dp, pro, part, B, H, W,
                                      C, F, tiles_per_block, s);
    else
      launch_wgrad<__nv_bfloat16, 32>(src, src2, c1, dp, pro, part, B, H, W,
                                      C, F, tiles_per_block, s);
  } else {
    if (F <= 16)
      launch_wgrad<float, 16>(src, src2, c1, dp, pro, part, B, H, W, C, F,
                              tiles_per_block, s);
    else
      launch_wgrad<float, 32>(src, src2, c1, dp, pro, part, B, H, W, C, F,
                              tiles_per_block, s);
  }
  return (int)cudaGetLastError();
}

// One pass of the column sum: in [R, N] -> out [ceil(R/rows_per_block), N].
int hpfg_colsum_f32(const void* in, void* out, int R, int N,
                    int rows_per_block, void* stream) {
  dim3 grid((N + 31) / 32, (R + rows_per_block - 1) / rows_per_block);
  colsum_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), R, N,
      rows_per_block);
  return (int)cudaGetLastError();
}

}  // extern "C"
