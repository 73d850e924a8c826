// Hand-written 3x3 SAME convolution kernels for the UNet ConvBlock on Hopper.
//
// Replaces (hpfg_tpu/ops/pallas/conv_block.py):
//   * conv3x3_kernel (fp32) and conv3x3_bf16_kernel (bf16), one source,
//     with the launcher hpfg_conv3x3_nhwc:
//       - kernel A: _conv_stats_kernel (K1), _bn_act_conv_stats_kernel (K2)
//         and _dgrad_kernel (K6); the C=1 stem, which _conv_stats_c1_kernel
//         (K12) serves on the TPU, is the C=1 case of the same kernel;
//       - K11 _dgrad_reduce_kernel: A in dgrad form (flipped weights, output
//         dropout mask) with the reduce epilogue (Reduce below) that takes the
//         next stage's BN-backward sums [sum dz, sum dz*xhat] from its own
//         rounded output rows, so that pass never reads them back from HBM;
//   * the same kernels with two sources or two outputs:
//       - K8 _conv_stats_cat_kernel: the UpBlock conv1 over the implicit
//         channel concat (skip || up): channel c < C1 is read from x, the rest
//         from x2. The concat is never written;
//       - K9 _dgrad_pair_kernel: the UpBlock conv1 dgrad; output channel
//         n < F1 goes to y (dx_skip), the rest to y2 (dx_up), each a
//         contiguous NHWC tensor for its own consumer;
//   * wgrad_kernel (fp32) and wgrad_bf16_kernel (bf16), launcher
//     hpfg_conv3x3_wgrad_nhwc: kernel B, _wgrad_kernel (K7) with its
//     _fold_wgrad, and with two sources K10 _wgrad_pair_kernel: one launch
//     over the concatenated channel range whose per-block partial row holds
//     [3,3,C1,F] then [3,3,C-C1,F];
//   * colsum_f32: the cross-grid accumulation the TPU kernels do in a
//     revisited output block (_flush_stats and the wgrad accumulator):
//     per-CTA partials are summed here in a fixed order, so runs are
//     deterministic.
// The dtype picks the kernel (is_bf16): every config trains in bf16, which
// runs on the tensor cores; fp32 has no tensor-core product at fp32
// precision, so it keeps the CUDA-core kernels.
//
// What bounds these kernels on an H100: the convolutions of the UNet have
// 1..256 input and 4..256 output channels; the 224^2 and 112^2 stages have
// few channels and many pixels, the 14^2 and 28^2 stages the reverse. Every
// stage does about the same number of FLOPs (an UpBlock conv1 is 14.8 GFLOP
// at batch 32 at every stage). The bound of the work itself is the larger of
// bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s (bf16 tensor cores): memory at
// 224^2 (up4.conv1: 154 MB, 46 us), operations at 28^2 (up1.conv1: 15 us).
// The fp32 kernels run on the CUDA cores (67 TFLOP/s peak) and are bound by
// FMA issue and shared-memory loads, far above either. The bf16 kernels
// feed mma.sync from ldmatrix. At the byte-bound stages the halo re-read
// (1.4x the input), the per-element prologue and the output stores set
// their pace; at the FLOP-bound stages the ldmatrix traffic (half an x4
// load per MMA with a 32x32 warp tile), the barriers of a two-stage
// pipeline and, in the wgrad, the prologue recomputed for every N tile and
// the split-K partials do. The pair and reduce forms add no HBM pass: K8
// reads each half once, K9 writes each half once, K11's reduce reads the
// residual h once and writes one [sum, sum^2]-sized partial per tile.
//
// What the design does about it:
//   * a block stages an 8x16-pixel tile (plus its 1-pixel halo) of the
//     input channels in shared memory, already transformed by the prologue
//     (BN affine + LeakyReLU + hash dropout) and rounded to the compute type,
//     so each input value is loaded from HBM and transformed once per output
//     channel tile instead of nine times; for a pair, each staged channel
//     picks its source, so a split that is not a multiple of the 8-channel
//     group stages both halves into one group;
//   * fp32: each thread keeps 4 pixels x 4 output channels in registers
//     and reads one 6-value input row per (channel, dy), reused by the three
//     dx taps: 48 FMAs per 9 shared-memory loads;
//   * bf16, conv: an implicit GEMM, M = the tile's 128 pixels, N = up to 128
//     output channels (fewer when the grid would leave SMs idle), K = 9 taps
//     x C in 16-channel chunks; the halo is staged in bf16, so tap (ky, kx)
//     is the same buffer at a shift and each ldmatrix row is one pixel's 16
//     channels; one A fragment serves three taps (ky reuse); weights come by
//     cp.async and stay resident when C <= 32; two stages, the next step's
//     loads issued before this step's MMAs, and a CTA walks a run of tiles
//     so a tile's epilogue overlaps the next tile's loads; the epilogue
//     rounds into a shared-memory tile and stores, and takes K11's reduce,
//     in 16-byte groups. These mma.sync kernels take the calls TMA cannot
//     (fp32, the C = 1 and 3 stems, the heads, A's output masks, odd pair
//     splits) and those a static rule of ops/conv_block.py conv_route
//     keeps here; the bf16 A, B and K8 to K11 calls whose channels (and
//     K9's split) are multiples of 8 run conv3x3_sm90.cu's wgmma/TMA
//     kernels, which apply the prologue to the TMA-staged box in shared
//     memory, split K9's output and take K11's reduce in their epilogue.
//     So K9 and K11 run here in fp32, and in bf16 where a channel count
//     or the split is not a multiple of 8 (the GPU tests' 12 + 20);
//   * bf16, wgrad: a split-K GEMM per tap, M = 16 or 32 input channels,
//     N = up to 32 output channels, K = the pixels of the CTA's run of
//     tiles; one warp per tap keeps its sums in registers over the run, two
//     CTAs an SM;
//   * the BN statistics (or K11's reduce terms) are reduced in registers and
//     warp shuffles, then across warps in a fixed order, and leave the block
//     as one [s0, s1] partial per channel and tile.
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
//     batch index of the pixel, never a block index: ids[b], its index in
//     the global batch under data parallelism (the int32 [B] image-id map
//     of the Prologue / OutMask), or b without a map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hash.cuh"
#include "mma.cuh"

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
  const int* ids;  // [B] global image index of each image, or null (b)
};

struct OutMask {
  int has_mask;
  uint32_t seed;
  uint32_t thresh;
  float scale;
  const int* ids;  // as Prologue::ids
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

// One fp32 conv operand: source pixel (y, x) of image b, channel c of a
// tensor with C channels, after the prologue; zero outside the image.
__device__ __forceinline__ float source_val(const float* __restrict__ src,
                                            const Prologue& pro, int b, int y,
                                            int x, int c, int H, int W,
                                            int C) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.f;
  float v = src[(((size_t)b * H + y) * W + x) * C + c];
  if (pro.a != nullptr) {
    // multiply and add rounded separately (no FMA), as the plain version
    // computes them, so both take the same LeakyReLU branch
    v = __fadd_rn(__fmul_rn(v, pro.a[c]), pro.b[c]);
    v = v >= 0.f ? v : v * kSlope;
    if (pro.has_mask)
      v *= hash_keep(pro.seed, pro.thresh, pro.scale,
                       image_index(pro.ids, b), y, W * C, x * C + c);
  }
  return v;
}

// Stage the transformed halo tile of channels [c0, c0+CC) into s_in.
// Channels c < C1 come from src ([B,H,W,C1]), the rest from src2
// ([B,H,W,C-C1], a pair's second half; the prologue is identity then).
template <int NT>
__device__ __forceinline__ void stage_halo(float* s_in,
                                           const float* __restrict__ src,
                                           const float* __restrict__ src2,
                                           int C1,
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
      v = source_val(src, pro, b, ty0 + r - 1, tx0 + col - 1, c, H, W, C1);
    else if (c < C)
      v = source_val(src2, pro, b, ty0 + r - 1, tx0 + col - 1, c - C1, H,
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
template <int BN>
__global__ void __launch_bounds__(32 * (BN / 4))
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ x2,
               int C1, const float* __restrict__ w,
               const float* __restrict__ bias, Prologue pro, OutMask om,
               Reduce<float> red, float* __restrict__ y,
               float* __restrict__ y2, int F1, float* __restrict__ part, int H,
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
    stage_halo<NT>(s_in, x, x2, C1, pro, b, ty0, tx0, c0, H, W, C);
    for (int i = tid; i < 9 * CC * BN; i += NT) {
      int nn = i % BN;
      int rest = i / BN;
      int cc = rest % CC;
      int tap = rest / CC;
      int n = n0 + nn;
      float v = 0.f;
      if (cc < ccn && n < F) v = w[((size_t)tap * C + c0 + cc) * F + n];
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
        o *= hash_keep(om.seed, om.thresh, om.scale,
                       image_index(om.ids, b), oy, W * F, ox * F + n);
      if (red.pre != nullptr) {
        const float p = red.pre[pix * F + n];
        const float z = __fadd_rn(__fmul_rn(p, red.a[n]), red.b[n]);
        const float dz = z >= 0.f ? o : o * kSlope;
        const float xhat = (p - red.m[n]) * red.inv[n];
        s[j] += dz;
        q2[j] += dz * xhat;
      } else {
        s[j] += o;
        q2[j] += o * o;
      }
      if (n < F1)
        y[pix * F1 + n] = o;
      else
        y2[pix * (F - F1) + (n - F1)] = o;
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
template <int BN>
__global__ void __launch_bounds__(CC * (BN / 4))
wgrad_kernel(const float* __restrict__ src, const float* __restrict__ src2,
             int C1, const float* __restrict__ dp, Prologue pro,
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
    stage_halo<NT>(s_in, src, src2, C1, pro, b, ty0, tx0, c0, H, W, C);
    for (int i = tid; i < TH * TW * BN; i += NT) {
      int nn = i % BN;
      int p = i / BN;
      int yy = ty0 + p / TW;
      int xx = tx0 + p % TW;
      int n = n0 + nn;
      float v = 0.f;
      if (yy < H && xx < W && n < F)
        v = dp[(((size_t)b * H + yy) * W + xx) * F + n];
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

// ---------------------------------------------------------------------------
// bf16: implicit GEMMs on the tensor cores (mma.sync m16n8k16, fp32 sums)
// ---------------------------------------------------------------------------
//
// The tensor-core helpers (bf2f / f2bf, cp.async, ldmatrix, mma_bf16) are in
// mma.cuh. Every staged tile in shared memory is pixel-major with its
// channels contiguous, in 16-byte groups of 8 channels, and every row (a
// pixel of a halo, a channel of a weight tile, a pixel of a dp tile) is
// padded by 16 bytes: the eight rows one ldmatrix phase reads (eight
// consecutive pixels or channels) then fall on eight different 16-byte bank
// groups, at every tap shift, and a tap's rows sit at a constant offset from
// tap 0's.

constexpr int KC = 16;  // input channels per K chunk of the bf16 conv

// Element offset of channel group g of halo pixel p in a tile of G groups
// (8 channels each) per pixel, rows padded by one group.
template <int G>
__device__ __forceinline__ int halo_off(int p, int g) {
  return p * (8 * G + 8) + 8 * g;
}

// The conv operand as the bf16 kernels stage it: channels c < C1 of x
// ([B,H,W,C1], through the prologue), the rest of x2 ([B,H,W,C-C1]).
struct HaloSrc {
  const uint16_t* x;
  const uint16_t* x2;
  int C1, C, H, W;
  Prologue pro;
};

// Slot s of a halo tile of G groups a pixel: its pixel p, group g, image
// position (gy, gx) and first channel c; true when it holds data (in the
// image, c < C), else it is zeros.
template <int G>
__device__ __forceinline__ bool halo_slot(const HaloSrc& hs, int s, int ty0,
                                          int tx0, int c0, int& p, int& g,
                                          int& gy, int& gx, int& c) {
  p = s / G;
  g = s % G;
  const int r = p / HALO_W;
  gy = ty0 + r - 1;
  gx = tx0 + (p - r * HALO_W) - 1;
  c = c0 + 8 * g;
  return gy >= 0 && gy < hs.H && gx >= 0 && gx < hs.W && c < hs.C;
}

__device__ __forceinline__ const uint16_t* halo_ptr(const HaloSrc& hs, int b,
                                                    int gy, int gx, int c) {
  const size_t pix = ((size_t)b * hs.H + gy) * hs.W + gx;
  return c < hs.C1 ? hs.x + pix * hs.C1 + c
                   : hs.x2 + pix * (hs.C - hs.C1) + (c - hs.C1);
}

// Identity operand, 16-byte aligned channel groups: cp.async, zero-filled
// outside the image and past C.
template <int G, int NT>
__device__ __forceinline__ void halo_async(uint16_t* s_a, const HaloSrc& hs,
                                           int b, int ty0, int tx0, int c0) {
  for (int s = threadIdx.x; s < HALO_PIX * G; s += NT) {
    int p, g, gy, gx, c;
    const bool v = halo_slot<G>(hs, s, ty0, tx0, c0, p, g, gy, gx, c);
    cp_async16(s_a + halo_off<G>(p, g), v ? halo_ptr(hs, b, gy, gx, c) : hs.x,
               v);
  }
}

// Register path, first half: the raw bf16 of this thread's slots (16-byte
// loads when vec, else one element at a time: C = 1, C = 4, odd splits).
template <int G, int NT, int SL>
__device__ __forceinline__ void halo_load(uint4 (&raw)[SL], const HaloSrc& hs,
                                          int vec, int b, int ty0, int tx0,
                                          int c0) {
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    const int s = threadIdx.x + i * NT;
    raw[i] = make_uint4(0u, 0u, 0u, 0u);
    int p, g, gy, gx, c;
    if (s >= HALO_PIX * G || !halo_slot<G>(hs, s, ty0, tx0, c0, p, g, gy, gx, c))
      continue;
    if (vec) {
      raw[i] = __ldg(reinterpret_cast<const uint4*>(halo_ptr(hs, b, gy, gx, c)));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < hs.C)
          w[e >> 1] |= (uint32_t)__ldg(halo_ptr(hs, b, gy, gx, c + e))
                       << (16 * (e & 1));
      raw[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The prologue's affine for channels [c0, c0 + n) into s_ab: a at
// s_ab[i], b at s_ab[n + i] (zero past C1); visible after a barrier.
template <int NT>
__device__ __forceinline__ void stage_affine(float* s_ab, const Prologue& pro,
                                             int c0, int n, int C1) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const int c = c0 + i;
    s_ab[i] = c < C1 ? pro.a[c] : 0.f;
    s_ab[n + i] = c < C1 ? pro.b[c] : 0.f;
  }
}

// Register path, second half: the prologue (BN affine, LeakyReLU, hash
// dropout; fp32, multiply and add rounded separately, as source_val) on
// in-image channels of x, rounded to bf16, stored to the halo tile. The
// affine of channel c comes from s_ab (stage_affine of channels from ab0,
// ab_n of them). IDS: the mask hashes ids[b] (read once a call), else b.
template <int G, int NT, int SL, bool IDS>
__device__ __forceinline__ void halo_store(uint16_t* s_a,
                                           const uint4 (&raw)[SL],
                                           const HaloSrc& hs, int b, int ty0,
                                           int tx0, int c0,
                                           const float* s_ab, int ab0,
                                           int ab_n) {
  const int bi = IDS ? image_index(hs.pro.ids, b) : b;
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    const int s = threadIdx.x + i * NT;
    if (s >= HALO_PIX * G) continue;
    int p, g, gy, gx, c;
    const bool v = halo_slot<G>(hs, s, ty0, tx0, c0, p, g, gy, gx, c);
    uint4 u = raw[i];
    if (v && hs.pro.a != nullptr) {
      uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ce = c + e;
        if (ce >= hs.C1) break;  // a pair's second half has no prologue
        const int sh = 16 * (e & 1);
        float f = bf2f((w[e >> 1] >> sh) & 0xFFFFu);
        f = __fadd_rn(__fmul_rn(f, s_ab[ce - ab0]), s_ab[ab_n + ce - ab0]);
        f = f >= 0.f ? f : f * kSlope;
        if (hs.pro.has_mask)
          f *= hash_keep(hs.pro.seed, hs.pro.thresh, hs.pro.scale, bi, gy,
                         hs.W * hs.C1, gx * hs.C1 + ce);
        w[e >> 1] = (w[e >> 1] & ~(0xFFFFu << sh)) | (f2bf(f) << sh);
      }
      u = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(s_a + halo_off<G>(p, g)) = u;
  }
}

// Geometry of the bf16 conv for an N tile of BN output channels: warps
// over (row pair, WN-wide channel slice) of the 8x16 output tile. Shared
// memory, in this order: two stages of the halo [HALO_PIX][KC + 8] and two
// of the weights [9][KC][BN + 8] (uint16); the rounded output tile
// [TH*TW][BN + 8] (uint16); the cross-warp sums [NWARP][BN][2] and K11's
// constants [4][BN] (fp32); with a prologue its affine [2][C] (fp32, sized
// at launch, at SMEM).
template <int BN>
struct ConvTC {
  static constexpr int WN = BN < 32 ? BN : 32;
  static constexpr int NJ = WN / 8;  // n8 fragments per warp
  static constexpr int WR = TH / 2;  // row pairs
  static constexpr int NWARP = WR * (BN / WN);
  static constexpr int NT = 32 * NWARP;
  static constexpr int BROW = BN + 8;
  static constexpr int A_ELEMS = HALO_PIX * (KC + 8);
  static constexpr int B_ELEMS = 9 * KC * BROW;
  static constexpr int OUT_OFF = 2 * (A_ELEMS + B_ELEMS);  // uint16 elements
  static constexpr int RED_OFF = (OUT_OFF + TH * TW * BROW) * 2;  // bytes
  static constexpr int RC_OFF = RED_OFF + NWARP * BN * 2 * 4;     // bytes
  static constexpr int SMEM = RC_OFF + 4 * BN * 4;  // bytes, without affine
  static constexpr int SL = (HALO_PIX * 2 + NT - 1) / NT;
};

// Weights [3,3,C,F] of chunk c0 into [9][KC][BN + 8]: cp.async when F is a
// multiple of 8 (async), else one element at a time (the logits head).
template <int BN, int NT>
__device__ __forceinline__ void stage_weights(uint16_t* s_b,
                                              const uint16_t* __restrict__ w,
                                              int async, int c0, int n0,
                                              int C, int F) {
  constexpr int BROW = BN + 8;
  if (async) {
    for (int s = threadIdx.x; s < 9 * KC * (BN / 8); s += NT) {
      const int q = s % (BN / 8);
      const int rest = s / (BN / 8);
      const int k = rest % KC;
      const int tap = rest / KC;
      const int c = c0 + k;
      const int n = n0 + 8 * q;
      const bool v = c < C && n < F;
      cp_async16(s_b + (tap * KC + k) * BROW + 8 * q,
                 v ? w + ((size_t)tap * C + c) * F + n : w, v);
    }
  } else {
    for (int s = threadIdx.x; s < 9 * KC * BN; s += NT) {
      const int nn = s % BN;
      const int rest = s / BN;
      const int k = rest % KC;
      const int tap = rest / KC;
      const int c = c0 + k;
      const int n = n0 + nn;
      s_b[(tap * KC + k) * BROW + nn] =
          c < C && n < F ? w[((size_t)tap * C + c) * F + n] : (uint16_t)0;
    }
  }
}

// The epilogue of one tile, which zeroes the accumulators after. First on
// the fragments: acc[i][j][2h + e] is output pixel (oy, ox) = (ty0 + 2wr +
// i, tx0 + lane/4 + 8h), channel n = n0 + wn*WN + 8j + 2(lane%4) + e: bias,
// output mask, the BN statistics of the fp32 result (lanes of a column by
// shuffles, then the row pairs in order through red_s), rounding into the
// output tile out_s. Then 16-byte groups of 8 channels of out_s go to y or
// y2 (o_vec: every group lies in one output at a 16-byte boundary), and
// K11's reduce is taken on them against 16-byte groups of pre (p_vec):
// per channel group over the thread's pixels, then over the lanes and
// warps of that group in order. Either sum lands in partial row t.
template <int BN, bool IDS>
__device__ __forceinline__ void conv_epilogue(
    float (&acc)[2][ConvTC<BN>::NJ][4], int b, int ty0, int tx0, int t,
    int wr, int wn, int lane, int tid, int n0, int H, int W, int F, int F1,
    const float* __restrict__ bias, const OutMask& om,
    const Reduce<uint16_t>& red, int o_vec, int p_vec,
    uint16_t* __restrict__ y, uint16_t* __restrict__ y2,
    float* __restrict__ part, uint16_t* out_s, float* red_s,
    const float* rc) {
  using K = ConvTC<BN>;
  constexpr int WN = K::WN, NJ = K::NJ, BROW = K::BROW, NT = K::NT;
  constexpr int QG = BN / 8;  // channel groups of the tile
  const bool stats = part != nullptr && red.pre == nullptr;
  const int bi = IDS ? image_index(om.ids, b) : b;  // the mask's image
  float s[NJ][2], q2[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = q2[j][0] = q2[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oy = ty0 + 2 * wr + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = (lane >> 2) + 8 * h;
      const int ox = tx0 + px;
      const bool in = oy < H && ox < W;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = wn * WN + 8 * j + 2 * (lane & 3);
        uint32_t ob[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ne = n0 + col + e;
          float o = acc[i][j][2 * h + e] +
                    (bias != nullptr && ne < F ? bias[ne] : 0.f);
          if (om.has_mask && in && ne < F)
            o *= hash_keep(om.seed, om.thresh, om.scale, bi, oy, W * F,
                           ox * F + ne);
          ob[e] = f2bf(o);
          if (stats && in && ne < F) {
            s[j][e] += o;
            q2[j][e] += o * o;
          }
          acc[i][j][2 * h + e] = 0.f;
        }
        *reinterpret_cast<uint32_t*>(out_s + ((2 * wr + i) * TW + px) * BROW +
                                     col) = ob[0] | (ob[1] << 16);
      }
    }
  }
  if (stats) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
          q2[j][e] += __shfl_xor_sync(0xffffffffu, q2[j][e], off);
        }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * WN + 8 * j + 2 * lane + e;
          red_s[(wr * BN + col) * 2] = s[j][e];
          red_s[(wr * BN + col) * 2 + 1] = q2[j][e];
        }
    }
  }
  __syncthreads();
  if (stats) {
    for (int col = tid; col < BN; col += NT) {
      const int n = n0 + col;
      if (n >= F) continue;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int r = 0; r < K::WR; ++r) {
        a0 += red_s[(r * BN + col) * 2];
        a1 += red_s[(r * BN + col) * 2 + 1];
      }
      part[(size_t)t * 2 * F + n] = a0;
      part[(size_t)t * 2 * F + F + n] = a1;
    }
  }

  // coalesced: thread tid takes channel group q = tid % QG of pixels
  // tid / QG, tid / QG + NT / QG, ...
  const int q = tid % QG;
  const int n = n0 + 8 * q;
  float rs[8], rq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) rs[e] = rq[e] = 0.f;
  for (int p = tid / QG; p < TH * TW; p += NT / QG) {
    const int oy = ty0 + p / TW, ox = tx0 + p % TW;
    if (oy >= H || ox >= W || n >= F) continue;
    const size_t pix = ((size_t)b * H + oy) * W + ox;
    const uint4 v = *reinterpret_cast<const uint4*>(out_s + p * BROW + 8 * q);
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
    if (o_vec && n + 8 <= F) {
      *reinterpret_cast<uint4*>(n < F1 ? y + pix * F1 + n
                                       : y2 + pix * (F - F1) + (n - F1)) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ne = n + e;
        if (ne >= F) break;
        const uint16_t h16 = (uint16_t)(w4[e >> 1] >> (16 * (e & 1)));
        if (ne < F1)
          y[pix * F1 + ne] = h16;
        else
          y2[pix * (F - F1) + (ne - F1)] = h16;
      }
    }
    if (red.pre != nullptr) {
      uint32_t p4[4] = {0u, 0u, 0u, 0u};
      if (p_vec && n + 8 <= F) {
        const uint4 pv = __ldg(reinterpret_cast<const uint4*>(red.pre +
                                                              pix * F + n));
        p4[0] = pv.x; p4[1] = pv.y; p4[2] = pv.z; p4[3] = pv.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < F)
            p4[e >> 1] |= (uint32_t)red.pre[pix * F + n + e] << (16 * (e & 1));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (n + e >= F) break;
        const int c = 8 * q + e;
        const float orr = bf2f((w4[e >> 1] >> (16 * (e & 1))) & 0xFFFFu);
        const float pv = bf2f((p4[e >> 1] >> (16 * (e & 1))) & 0xFFFFu);
        const float z = __fadd_rn(__fmul_rn(pv, rc[c]), rc[BN + c]);
        const float dz = z >= 0.f ? orr : orr * kSlope;
        const float xhat = (pv - rc[2 * BN + c]) * rc[3 * BN + c];
        rs[e] += dz;
        rq[e] += dz * xhat;
      }
    }
  }
  if (red.pre != nullptr && part != nullptr) {
    const int warp = tid >> 5;
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = QG; off < 32; off <<= 1) {
        rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], off);
        rq[e] += __shfl_xor_sync(0xffffffffu, rq[e], off);
      }
    if (lane < QG) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red_s[(warp * BN + 8 * lane + e) * 2] = rs[e];
        red_s[(warp * BN + 8 * lane + e) * 2 + 1] = rq[e];
      }
    }
    __syncthreads();
    for (int col = tid; col < BN; col += NT) {
      const int nn = n0 + col;
      if (nn >= F) continue;
      float a0 = 0.f, a1 = 0.f;
      for (int r = 0; r < K::NWARP; ++r) {
        a0 += red_s[(r * BN + col) * 2];
        a1 += red_s[(r * BN + col) * 2 + 1];
      }
      part[(size_t)t * 2 * F + nn] = a0;
      part[(size_t)t * 2 * F + F + nn] = a1;
    }
  }
}

// conv3x3_kernel's bf16 form: the same function, an implicit GEMM on the
// tensor cores. M = the 8x16 output pixels of a tile, N = BN output
// channels, K = 9 taps x C in chunks of KC = 16 input channels. Warp
// (wr, wn) owns output rows 2wr, 2wr+1 (two m16 fragments: a row is 16
// pixels) and channels [wn*WN, wn*WN + WN). A CTA walks a run of tiles,
// one (tile, chunk) step at a time: the halo (A; tap (ky, kx) is the same
// buffer seen at a shift, each ldmatrix row one pixel's 16 channels) and
// the weights (B, ldmatrix.trans) are staged in a double buffer, the next
// step's copies issued before this step's MMAs (cp.async for identity
// operands and weights; global loads to registers for a prologue'd
// operand, transformed and stored after them), so a tile's epilogue runs
// while the next tile's loads are in flight. The copies go out after the
// step's one barrier: past it no warp still reads the buffer they fill. With at most two chunks the
// weights stay resident over the run. a_async: identity operand with
// 16-byte channel groups; a_vec: 16-byte loads on the register path;
// b_async: weights by cp.async. IDS: the masks hash the image-id maps
// (Prologue::ids, OutMask::ids; each may be null); without it, the local
// index b, with no code for a map (every one-process launch).
template <int BN, bool IDS>
__global__ void __launch_bounds__(ConvTC<BN>::NT, 512 / ConvTC<BN>::NT)
conv3x3_bf16_kernel(HaloSrc hs, const uint16_t* __restrict__ w,
                    const float* __restrict__ bias, OutMask om,
                    Reduce<uint16_t> red, uint16_t* __restrict__ y,
                    uint16_t* __restrict__ y2, int F1,
                    float* __restrict__ part, int F, int tiles_x,
                    int tiles_per_img, int total_tiles, int tiles_per_cta,
                    int a_async, int a_vec, int b_async, int o_vec,
                    int p_vec) {
  using K = ConvTC<BN>;
  constexpr int NT = K::NT, WN = K::WN, NJ = K::NJ, BROW = K::BROW;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* s_a = smem;                   // [2][A_ELEMS]
  uint16_t* s_b = smem + 2 * K::A_ELEMS;  // [2][B_ELEMS]
  unsigned char* smem_b = reinterpret_cast<unsigned char*>(smem);
  uint16_t* out_s = smem + K::OUT_OFF;
  float* red_s = reinterpret_cast<float*>(smem_b + K::RED_OFF);
  float* rc = reinterpret_cast<float*>(smem_b + K::RC_OFF);
  float* s_ab = reinterpret_cast<float*>(smem_b + K::SMEM);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp % K::WR;
  const int wn = warp / K::WR;
  const int lr = lane & 7, lq = lane >> 3;
  const int n0 = blockIdx.y * BN;
  const int H = hs.H, W = hs.W, C = hs.C;
  const int nchunks = (C + KC - 1) / KC;
  const bool wres = nchunks <= 2;  // chunk k's weights stay in buffer k
  const int t_begin = blockIdx.x * tiles_per_cta;
  const int nsteps = (min(t_begin + tiles_per_cta, total_tiles) - t_begin) *
                     nchunks;
  auto tile_of = [&](int t, int& b, int& ty0, int& tx0) {
    b = t / tiles_per_img;
    const int tt = t - b * tiles_per_img;
    ty0 = (tt / tiles_x) * TH;
    tx0 = (tt % tiles_x) * TW;
  };

  float acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (red.pre != nullptr) {  // K11's constants of this N tile
    for (int c = tid; c < BN; c += NT) {
      const int n = n0 + c;
      rc[c] = n < F ? red.a[n] : 0.f;
      rc[BN + c] = n < F ? red.b[n] : 0.f;
      rc[2 * BN + c] = n < F ? red.m[n] : 0.f;
      rc[3 * BN + c] = n < F ? red.inv[n] : 0.f;
    }
  }

  uint4 raw[K::SL];
  {
    int b, ty0, tx0;
    tile_of(t_begin, b, ty0, tx0);
    if (a_async) {
      halo_async<2, NT>(s_a, hs, b, ty0, tx0, 0);
    } else {
      halo_load<2, NT, K::SL>(raw, hs, a_vec, b, ty0, tx0, 0);
      if (hs.pro.a != nullptr) {
        stage_affine<NT>(s_ab, hs.pro, 0, hs.C1, hs.C1);
        __syncthreads();
      }
      halo_store<2, NT, K::SL, IDS>(s_a, raw, hs, b, ty0, tx0, 0, s_ab, 0,
                                    hs.C1);
    }
    stage_weights<BN, NT>(s_b, w, b_async, 0, n0, C, F);
    cp_async_commit();
  }

  for (int s = 0; s < nsteps; ++s) {
    const int k = s % nchunks;
    const int t = t_begin + s / nchunks;
    const uint16_t* sa = s_a + (s & 1) * K::A_ELEMS;
    const uint16_t* sb = s_b + (wres ? k : s & 1) * K::B_ELEMS;
    // the next step: its halo, and its weights unless resident already
    const bool more = s + 1 < nsteps;
    const int k1 = (s + 1) % nchunks;
    const bool w1 = more && (!wres || s + 1 < nchunks);
    uint16_t* na = s_a + ((s + 1) & 1) * K::A_ELEMS;
    uint16_t* nb = s_b + (wres ? k1 : (s + 1) & 1) * K::B_ELEMS;
    cp_async_wait0();  // this step's copies have landed,
    __syncthreads();   // and every warp is done with step s - 1's buffers
    int b1 = 0, ty1 = 0, tx1 = 0;
    if (more) {
      tile_of(t_begin + (s + 1) / nchunks, b1, ty1, tx1);
      if (a_async)
        halo_async<2, NT>(na, hs, b1, ty1, tx1, k1 * KC);
      else
        halo_load<2, NT, K::SL>(raw, hs, a_vec, b1, ty1, tx1, k1 * KC);
      if (w1 && b_async)
        stage_weights<BN, NT>(nb, w, 1, k1 * KC, n0, C, F);
    }
    cp_async_commit();

    // halo row 2wr + r at shift kx is output row i's A at tap (r - i, kx):
    // four A fragments serve the warp's two rows at the three ky
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t af[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = (2 * wr + r) * HALO_W + kx + lr + 8 * (lq & 1);
        ldsm_x4(af[r], sa + halo_off<2>(p, lq >> 1));
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const uint16_t* brow =
            sb + ((ky * 3 + kx) * KC + lr + 8 * (lq & 1)) * BROW + wn * WN;
        if constexpr (WN >= 16) {
#pragma unroll
          for (int jj = 0; jj < WN / 16; ++jj) {
            uint32_t bf[4];
            ldsm_x4_t(bf, brow + 16 * jj + 8 * (lq >> 1));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][2 * jj], af[i + ky], bf[0], bf[1]);
              mma_bf16(acc[i][2 * jj + 1], af[i + ky], bf[2], bf[3]);
            }
          }
        } else {
          uint32_t bf[2];
          ldsm_x2_t(bf, brow);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_bf16(acc[i][0], af[i + ky], bf[0], bf[1]);
        }
      }
    }

    if (more) {
      if (!a_async)
        halo_store<2, NT, K::SL, IDS>(na, raw, hs, b1, ty1, tx1, k1 * KC,
                                      s_ab, 0, hs.C1);
      if (w1 && !b_async) stage_weights<BN, NT>(nb, w, 0, k1 * KC, n0, C, F);
    }
    if (k == nchunks - 1) {
      int b, ty0, tx0;
      tile_of(t, b, ty0, tx0);
      conv_epilogue<BN, IDS>(acc, b, ty0, tx0, t, wr, wn, lane, tid, n0, H, W,
                             F, F1, bias, om, red, o_vec, p_vec, y, y2, part,
                             out_s, red_s, rc);
    }
  }
}

// Geometry of the bf16 wgrad for a CM x BN (input x output channel) tile:
// nine warps, one per tap; per stage the halo [HALO_PIX][CM + 8] and the dp
// tile [TH*TW][BN + 8]; then the prologue's affine [2][CM] fp32.
template <int CM, int BN>
struct WgradTC {
  static constexpr int G = CM / 8;
  static constexpr int NT = 9 * 32;
  static constexpr int MI = CM / 16;  // m16 fragments
  static constexpr int NJ = BN / 8;   // n8 fragments
  static constexpr int DROW = BN + 8;
  static constexpr int A_ELEMS = HALO_PIX * (CM + 8);
  static constexpr int STAGE = A_ELEMS + TH * TW * DROW;  // uint16 elements
  static constexpr int SMEM = 2 * STAGE * 2 + 2 * CM * 4;  // + the affine
  static constexpr int SL = (HALO_PIX * G + NT - 1) / NT;
};

// dp of one 8x16 tile, channels [n0, n0 + BN), into [TH*TW][BN + 8]; zero
// outside the image and past F.
template <int BN, int NT>
__device__ __forceinline__ void stage_dp(uint16_t* s_d,
                                         const uint16_t* __restrict__ dp,
                                         int async, int b, int ty0, int tx0,
                                         int n0, int H, int W, int F) {
  constexpr int DROW = BN + 8;
  if (async) {
    for (int s = threadIdx.x; s < TH * TW * (BN / 8); s += NT) {
      const int q = s % (BN / 8);
      const int pp = s / (BN / 8);
      const int yy = ty0 + pp / TW, xx = tx0 + pp % TW;
      const int n = n0 + 8 * q;
      const bool v = yy < H && xx < W && n < F;
      cp_async16(s_d + pp * DROW + 8 * q,
                 v ? dp + (((size_t)b * H + yy) * W + xx) * F + n : dp, v);
    }
  } else {
    for (int s = threadIdx.x; s < TH * TW * BN; s += NT) {
      const int nn = s % BN;
      const int pp = s / BN;
      const int yy = ty0 + pp / TW, xx = tx0 + pp % TW;
      const int n = n0 + nn;
      s_d[pp * DROW + nn] =
          yy < H && xx < W && n < F
              ? dp[(((size_t)b * H + yy) * W + xx) * F + n]
              : (uint16_t)0;
    }
  }
}

// wgrad_kernel's bf16 form: dW[tap, c, f] = sum_p src'[p + tap, c] dp[p, f]
// as a split-K GEMM on the tensor cores, M = CM input channels, N = BN
// output channels, K = the pixels of this CTA's run of 8x16 tiles (one k16
// step per tile row). Warp `tap` keeps its tap's CM x BN fp32 sums in
// registers across the run. Both operands are pixel-major in shared memory
// and enter the MMA through ldmatrix.trans; the next tile's halo and dp are
// staged during this tile's MMAs as in conv3x3_bf16_kernel. The partial
// row of the CTA ([3,3,C1,F] then [3,3,C-C1,F]) is summed by colsum.
// IDS as in conv3x3_bf16_kernel.
template <int CM, int BN, bool IDS>
__global__ void __launch_bounds__(WgradTC<CM, BN>::NT, 2)
wgrad_bf16_kernel(HaloSrc hs, const uint16_t* __restrict__ dp,
                  float* __restrict__ part, int F, int tiles_x,
                  int tiles_per_img, int total_tiles, int tiles_per_block,
                  int a_async, int a_vec, int d_async) {
  using K = WgradTC<CM, BN>;
  constexpr int NT = K::NT, G = K::G, MI = K::MI, NJ = K::NJ;
  constexpr int DROW = K::DROW;
  extern __shared__ __align__(16) uint16_t smem[];

  const int lane = threadIdx.x & 31;
  const int tap = threadIdx.x >> 5;
  const int ky = tap / 3, kx = tap % 3;
  const int lr = lane & 7, lq = lane >> 3;
  const int c0 = blockIdx.y * CM;
  const int n0 = blockIdx.z * BN;
  const int H = hs.H, W = hs.W, C = hs.C, C1 = hs.C1;

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, total_tiles);
  auto tile_of = [&](int t, int& b, int& ty0, int& tx0) {
    b = t / tiles_per_img;
    const int tt = t - b * tiles_per_img;
    ty0 = (tt / tiles_x) * TH;
    tx0 = (tt % tiles_x) * TW;
  };

  uint4 raw[K::SL];
  float* s_ab = reinterpret_cast<float*>(smem + 2 * K::STAGE);
  {
    int b, ty0, tx0;
    tile_of(t_begin, b, ty0, tx0);
    if (a_async) {
      halo_async<G, NT>(smem, hs, b, ty0, tx0, c0);
    } else {
      halo_load<G, NT, K::SL>(raw, hs, a_vec, b, ty0, tx0, c0);
      if (hs.pro.a != nullptr) {
        stage_affine<NT>(s_ab, hs.pro, c0, CM, C1);
        __syncthreads();
      }
      halo_store<G, NT, K::SL, IDS>(smem, raw, hs, b, ty0, tx0, c0, s_ab, c0,
                                    CM);
    }
    stage_dp<BN, NT>(smem + K::A_ELEMS, dp, d_async, b, ty0, tx0, n0, H, W,
                     F);
    cp_async_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    uint16_t* cur = smem + ((t - t_begin) & 1) * K::STAGE;
    uint16_t* nxt = smem + ((t - t_begin + 1) & 1) * K::STAGE;
    const bool more = t + 1 < t_end;
    cp_async_wait0();  // as in conv3x3_bf16_kernel: one barrier a tile
    __syncthreads();
    int nb = 0, nty0 = 0, ntx0 = 0;
    if (more) {
      tile_of(t + 1, nb, nty0, ntx0);
      if (a_async)
        halo_async<G, NT>(nxt, hs, nb, nty0, ntx0, c0);
      else
        halo_load<G, NT, K::SL>(raw, hs, a_vec, nb, nty0, ntx0, c0);
      if (d_async)
        stage_dp<BN, NT>(nxt + K::A_ELEMS, dp, 1, nb, nty0, ntx0, n0, H, W,
                         F);
    }
    cp_async_commit();

    const uint16_t* sa = cur;
    const uint16_t* sd = cur + K::A_ELEMS;
#pragma unroll 2
    for (int r = 0; r < TH; ++r) {
      // A = src' at the tap's shift: rows k = the row's 16 pixels, cols m
      // = channels, transposed by ldmatrix.trans
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int p = (r + ky) * HALO_W + kx + lr + 8 * (lq >> 1);
        ldsm_x4_t(af[mi], sa + halo_off<G>(p, 2 * mi + (lq & 1)));
      }
      const uint16_t* drow = sd + (r * TW + lr + 8 * (lq & 1)) * DROW;
      if constexpr (BN >= 16) {
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj) {
          uint32_t bf[4];
          ldsm_x4_t(bf, drow + 16 * jj + 8 * (lq >> 1));
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][2 * jj], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * jj + 1], af[mi], bf[2], bf[3]);
          }
        }
      } else {
        uint32_t bf[2];
        ldsm_x2_t(bf, drow);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          mma_bf16(acc[mi][0], af[mi], bf[0], bf[1]);
      }
    }

    if (more) {
      if (!a_async)
        halo_store<G, NT, K::SL, IDS>(nxt, raw, hs, nb, nty0, ntx0, c0, s_ab,
                                      c0, CM);
      if (!d_async)
        stage_dp<BN, NT>(nxt + K::A_ELEMS, dp, 0, nb, nty0, ntx0, n0, H, W,
                         F);
    }
  }

  // acc[mi][j][2h + e]: channel c = c0 + 16mi + lane/4 + 8h, output
  // channel f = n0 + 8j + 2(lane%4) + e
  float* row = part + (size_t)blockIdx.x * 9 * C * F;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 16 * mi + (lane >> 2) + 8 * h;
      if (c >= C) continue;
      float* out = c < C1 ? row + ((size_t)tap * C1 + c) * F
                          : row + (size_t)9 * C1 * F +
                                ((size_t)tap * (C - C1) + (c - C1)) * F;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = n0 + 8 * j + 2 * (lane & 3) + e;
          if (f < F) out[f] = acc[mi][j][2 * h + e];
        }
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

template <int BN>
void launch_conv(const ConvArgs& a, int B, int H, int W, int C, int F,
                 cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, (F + BN - 1) / BN, B);
  Reduce<float> red{static_cast<const float*>(a.pre), a.ra, a.rb, a.rm,
                    a.rinv};
  conv3x3_kernel<BN><<<grid, 32 * (BN / 4), 0, stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.x2), a.c1,
      static_cast<const float*>(a.w), static_cast<const float*>(a.bias),
      a.pro, a.om, red, static_cast<float*>(a.y), static_cast<float*>(a.y2),
      a.f1,
      static_cast<float*>(a.part), H, W, C, F, tiles_x);
}

template <int BN>
void launch_wgrad(const void* src, const void* src2, int c1, const void* dp,
                  const Prologue& pro, void* part, int B, int H, int W, int C,
                  int F, int tiles_per_block, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + TH - 1) / TH);
  const int total = B * tiles_per_img;
  dim3 grid((total + tiles_per_block - 1) / tiles_per_block,
            (C + CC - 1) / CC, (F + BN - 1) / BN);
  wgrad_kernel<BN><<<grid, CC * (BN / 4), 0, stream>>>(
      static_cast<const float*>(src), static_cast<const float*>(src2), c1,
      static_cast<const float*>(dp), pro, static_cast<float*>(part), H, W, C, F,
      tiles_x, tiles_per_img, total, tiles_per_block);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The bf16 operand: x (c < c1) || x2, with its prologue; vec: every
// 8-channel group lies in one source at a 16-byte boundary.
HaloSrc halo_src(const void* x, const void* x2, int c1, int C, int H, int W,
                 const Prologue& pro, int* vec) {
  *vec = c1 % 8 == 0 && (C - c1) % 8 == 0 && aligned16(x) &&
         (x2 == nullptr || aligned16(x2));
  return HaloSrc{static_cast<const uint16_t*>(x),
                 static_cast<const uint16_t*>(x2), c1, C, H, W, pro};
}

// CTAs the bf16 conv aims to keep in flight: one per SM of the H100's 132
// as the fewest (below it the N tile shrinks, down to 32 channels), about
// eight per SM as the most (above it a CTA walks a run of tiles).
constexpr int CONV_MIN_CTAS = 132;
// the most dynamic shared memory a block may use on an H100
constexpr int MAX_SMEM = 232448;
constexpr int CONV_TARGET_CTAS = 1024;

// The N tile of the bf16 conv: the output channels rounded up to a whole
// n8 fragment, at most 128, halved while the grid would leave SMs idle.
int conv_bn_bf16(int F, int tiles) {
  int bn = F <= 8 ? 8 : F <= 16 ? 16 : F <= 32 ? 32 : F <= 64 ? 64 : 128;
  while (bn > 32 && tiles * ((F + bn - 1) / bn) < CONV_MIN_CTAS) bn /= 2;
  return bn;
}

template <int BN>
void launch_conv_bf16(const ConvArgs& a, int B, int H, int W, int C, int F,
                      cudaStream_t stream) {
  using K = ConvTC<BN>;
  // above 48 KB of dynamic shared memory needs the opt-in, once a process
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(conv3x3_bf16_kernel<BN, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM),
      cudaFuncSetAttribute(conv3x3_bf16_kernel<BN, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM)};
  (void)attr;  // a refusal shows as the launch's error
  const auto kernel = a.pro.ids != nullptr || a.om.ids != nullptr
                          ? conv3x3_bf16_kernel<BN, true>
                          : conv3x3_bf16_kernel<BN, false>;
  int vec;
  const HaloSrc hs = halo_src(a.x, a.x2, a.c1, C, H, W, a.pro, &vec);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + TH - 1) / TH);
  const int total = B * tiles_per_img;
  const int ntn = (F + BN - 1) / BN;
  const int per = std::max(1, total * ntn / CONV_TARGET_CTAS);
  dim3 grid((total + per - 1) / per, ntn);
  Reduce<uint16_t> red{static_cast<const uint16_t*>(a.pre), a.ra, a.rb, a.rm,
                       a.rinv};
  const int smem = K::SMEM + (a.pro.a != nullptr ? 8 * a.c1 : 0);
  kernel<<<grid, K::NT, smem, stream>>>(
      hs, static_cast<const uint16_t*>(a.w), static_cast<const float*>(a.bias),
      a.om, red, static_cast<uint16_t*>(a.y), static_cast<uint16_t*>(a.y2),
      a.f1, static_cast<float*>(a.part), F, tiles_x, tiles_per_img, total,
      per, vec && a.pro.a == nullptr, vec, F % 8 == 0 && aligned16(a.w),
      a.f1 % 8 == 0 && (F - a.f1) % 8 == 0 && aligned16(a.y) &&
          (a.y2 == nullptr || aligned16(a.y2)),
      F % 8 == 0 && aligned16(a.pre));
}

// The wgrad tiles: input channels (CC in fp32; 16 or 32 in bf16) and
// output channels (in bf16 at most 32: a warp's sums, one tap's CM x BN,
// then take at most 32 registers and two CTAs fit an SM).
int wgrad_cm(int C, int is_bf16) { return is_bf16 && C > 16 ? 32 : CC; }
int wgrad_bn(int F, int is_bf16) {
  if (!is_bf16) return F <= 16 ? 16 : 32;
  return F <= 8 ? 8 : F <= 16 ? 16 : 32;
}

template <int CM, int BN>
void launch_wgrad_bf16(const void* src, const void* src2, int c1,
                       const void* dp, const Prologue& pro, void* part, int B,
                       int H, int W, int C, int F, int tiles_per_block,
                       cudaStream_t stream) {
  using K = WgradTC<CM, BN>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(wgrad_bf16_kernel<CM, BN, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           K::SMEM),
      cudaFuncSetAttribute(wgrad_bf16_kernel<CM, BN, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           K::SMEM)};
  (void)attr;
  const auto kernel = pro.ids != nullptr ? wgrad_bf16_kernel<CM, BN, true>
                                         : wgrad_bf16_kernel<CM, BN, false>;
  int vec;
  const HaloSrc hs = halo_src(src, src2, c1, C, H, W, pro, &vec);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + TH - 1) / TH);
  const int total = B * tiles_per_img;
  dim3 grid((total + tiles_per_block - 1) / tiles_per_block,
            (C + CM - 1) / CM, (F + BN - 1) / BN);
  kernel<<<grid, K::NT, K::SMEM, stream>>>(
      hs, static_cast<const uint16_t*>(dp), static_cast<float*>(part), F,
      tiles_x, tiles_per_img, total, tiles_per_block,
      vec && pro.a == nullptr, vec, F % 8 == 0 && aligned16(dp));
}

template <int CM>
void launch_wgrad_bf16_bn(const void* src, const void* src2, int c1,
                          const void* dp, const Prologue& pro, void* part,
                          int B, int H, int W, int C, int F, int tpb,
                          cudaStream_t s) {
  switch (wgrad_bn(F, 1)) {
    case 8:
      return launch_wgrad_bf16<CM, 8>(src, src2, c1, dp, pro, part, B, H, W,
                                      C, F, tpb, s);
    case 16:
      return launch_wgrad_bf16<CM, 16>(src, src2, c1, dp, pro, part, B, H, W,
                                       C, F, tpb, s);
    default:
      return launch_wgrad_bf16<CM, 32>(src, src2, c1, dp, pro, part, B, H, W,
                                       C, F, tpb, s);
  }
}

}  // namespace

extern "C" {

// The launch geometry the Python wrappers size their buffers by: the
// output tile of both conv kernels and both wgrad kernels (TH x TW pixels)
// and the wgrad kernel's channel tiles for C input and F output channels.
int hpfg_tile_h() { return TH; }
int hpfg_tile_w() { return TW; }
int hpfg_wgrad_cm(int C, int is_bf16) { return wgrad_cm(C, is_bf16); }
int hpfg_wgrad_bn(int F, int is_bf16) { return wgrad_bn(F, is_bf16); }

// One launch of conv3x3_kernel (fp32) or conv3x3_bf16_kernel (bf16); every
// kernel-A form goes through here.
// x [B,H,W,c1] and x2 [B,H,W,C-c1] (null unless a pair; c1 = C then), w
// [3,3,C,F] (all bf16 when is_bf16, else fp32), bias [F] fp32 or null,
// pa/pb [C] fp32 or null (identity source), in_ids / out_ids int32 [B]
// (each image's index in the global batch, hashed by the input and output
// dropout masks) or null (the local index), y [B,H,W,f1] and y2
// [B,H,W,F-f1] (null unless a split output; f1 = F then), part
// [B*tiles, 2, F] fp32 or null (no epilogue sums); pre [B,H,W,F] of x's type
// plus ra/rb/rm/rinv [F] fp32 select the reduce epilogue (else null).
int hpfg_conv3x3_nhwc(const void* x, const void* x2, int c1, const void* w,
                      const void* bias, const void* pa, const void* pb,
                      int in_mask, unsigned in_seed, unsigned in_thresh,
                      float in_scale, const void* in_ids, int out_mask,
                      unsigned out_seed, unsigned out_thresh,
                      float out_scale, const void* out_ids, const void* pre,
                      const void* ra, const void* rb, const void* rm,
                      const void* rinv, void* y, void* y2, int f1, void* part,
                      int B, int H, int W, int C, int F, int is_bf16,
                      void* stream) {
  ConvArgs a{x, x2, c1, w, bias,
             Prologue{static_cast<const float*>(pa),
                      static_cast<const float*>(pb), in_mask, in_seed,
                      in_thresh, in_scale, static_cast<const int*>(in_ids)},
             OutMask{out_mask, out_seed, out_thresh, out_scale,
                     static_cast<const int*>(out_ids)},
             pre, static_cast<const float*>(ra), static_cast<const float*>(rb),
             static_cast<const float*>(rm), static_cast<const float*>(rinv),
             y, y2, f1, part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int tiles = B * ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
    switch (conv_bn_bf16(F, tiles)) {
      case 8: launch_conv_bf16<8>(a, B, H, W, C, F, s); break;
      case 16: launch_conv_bf16<16>(a, B, H, W, C, F, s); break;
      case 32: launch_conv_bf16<32>(a, B, H, W, C, F, s); break;
      case 64: launch_conv_bf16<64>(a, B, H, W, C, F, s); break;
      default: launch_conv_bf16<128>(a, B, H, W, C, F, s); break;
    }
  } else {
    if (F <= 16)
      launch_conv<16>(a, B, H, W, C, F, s);
    else
      launch_conv<32>(a, B, H, W, C, F, s);
  }
  return (int)cudaGetLastError();
}

// src [B,H,W,c1] and src2 [B,H,W,C-c1] (null unless a pair; c1 = C then),
// dp [B,H,W,F], ids as hpfg_conv3x3_nhwc's in_ids; part [rows, 9*C*F]
// fp32 with rows = ceil(B*tiles / tiles_per_block).
int hpfg_conv3x3_wgrad_nhwc(const void* src, const void* src2, int c1,
                            const void* dp, const void* pa, const void* pb,
                            int in_mask, unsigned seed, unsigned thresh,
                            float scale, const void* ids, void* part, int B,
                            int H, int W, int C, int F, int tiles_per_block,
                            int is_bf16, void* stream) {
  Prologue pro{static_cast<const float*>(pa), static_cast<const float*>(pb),
               in_mask, seed, thresh, scale, static_cast<const int*>(ids)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (wgrad_cm(C, 1) == 16)
      launch_wgrad_bf16_bn<16>(src, src2, c1, dp, pro, part, B, H, W, C, F,
                               tiles_per_block, s);
    else
      launch_wgrad_bf16_bn<32>(src, src2, c1, dp, pro, part, B, H, W, C, F,
                               tiles_per_block, s);
  } else {
    if (wgrad_bn(F, 0) == 16)
      launch_wgrad<16>(src, src2, c1, dp, pro, part, B, H, W, C, F,
                              tiles_per_block, s);
    else
      launch_wgrad<32>(src, src2, c1, dp, pro, part, B, H, W, C, F,
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
