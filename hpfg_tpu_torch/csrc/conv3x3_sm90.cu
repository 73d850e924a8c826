// The ConvBlock convs in bf16 on Hopper's own tensor-core path: wgmma
// (warpgroup MMA, fp32 sums in registers) fed by TMA (tensor-map bulk
// copies into shared memory, completion on mbarriers). sm_90a only.
//
// Replaces (hpfg_tpu/ops/pallas/conv_block.py):
//   * kernel A, the 3x3 conv of one source, in its two operand forms:
//     identity (_conv_stats_kernel, K1, conv_block.py:734: conv1 + bias +
//     the BN [sum, sum^2]; _dgrad_kernel, K6, :1176: conv1's input
//     gradient on the flip-transposed weights; and the plain convs) and
//     prologue (_bn_act_conv_stats_kernel, K2, :785: conv2 over
//     lrelu(a*h + b) * mask); and K8 _conv_stats_cat_kernel (:772), the
//     UpBlock conv1 over the implicit channel concat (skip || up), as its
//     two-source case: conv_sm90_kernel, launcher hpfg_conv_sm90;
//   * with the same kernel in dgrad form (flip-transposed weights, an
//     identity operand, no bias): K9 _dgrad_pair_kernel (:1364), the
//     UpBlock conv1's input gradient, its output split at Ca into dx_skip
//     and dx_up (two tensors, two store maps), and K11
//     _dgrad_reduce_kernel (:1525), conv2's input gradient times the
//     forward's dropout mask with BN1's backward reduce in the epilogue
//     (conv_sm90_kernel<N, TALL, false, true>);
//   * kernel B, _wgrad_kernel (K7, :1192) with its _fold_wgrad (:1250), in
//     both operand forms, and K10 _wgrad_pair_kernel (:1453), the pair
//     conv's weight gradients [3,3,Ca,F] then [3,3,Cb,F] in one launch, as
//     its two-source case: wgrad_sm90_kernel, launcher hpfg_wgrad_sm90.
// ops/conv_block.py (conv_route, pair_route) sends a bf16 call here when
// TMA can take its tensors (channels, and K9's split, multiples of 8,
// 16-byte aligned bases); fp32, the C = 1 and C = 3 stems (K12's), the
// heads, A with an output dropout mask and the static rules of
// conv_route keep conv3x3.cu's mma.sync kernels.
//
// What bounds them on an H100: each ConvBlock conv of the UNet is 4 to 15
// GFLOP at batch 32 (4 to 15 us at 989 TFLOP/s); at 14^2 to 56^2 (64 to
// 256 channels) operations bound them, at 112^2 and 224^2 (16 and 32) the
// bytes of x and y (up to 46 us at 3.35 TB/s). wgmma is Hopper's only path
// to its full tensor rate; at the byte-bound stages what counts is keeping
// enough copies in flight; at 14^2 (32 images of 196 pixels at batch 32) it
// is filling 132 SMs from few pixels. B also writes a split-K partial row
// a CTA, which the column sum reads back, and the prologue form of both
// hashes its dropout mask on the CUDA cores beside the MMAs.
//
// What the design does about it:
//   * operands come by TMA into a ring of stages (four; three in the conv
//     at N >= 64, whose output tile takes the room), one mbarrier each
//     (expect-tx bytes); one thread issues the copies of step s + stages
//     once every warp is past step s, so the ring's steps of loads are in
//     flight while the warpgroups multiply;
//   * the activations come as a halo box of 16 channels (one source's
//     channel group: a step's K never spans the two halves of a pair, so
//     the concat is never written) over the tile plus its one-pixel rim,
//     from a 4-D tensor map [C, W, H, B]. TMA fills what lies outside the
//     image (or past the source's channels) with zeros: that is the SAME
//     padding of the identity form, and a channel count that is a multiple
//     of 8 but not 16 gets a zero group tail. 32-byte swizzle: the 16-byte
//     halves of eight consecutive pixels fall in eight different bank
//     groups;
//   * the prologue form (BN affine, LeakyReLU, hash dropout) cannot ride
//     on TMA, which copies bytes untouched: the raw h box lands by TMA and
//     the CTA's threads transform it once, in shared memory and in place,
//     before any warp reads it (prologue_box): each 16-byte half's pixel
//     and channels come from un-swizzling its address, the affine is a
//     multiply then an add (no FMA) in fp32, the mask is hash.cuh's
//     (seed, image id, row, lane = x*C + c) and the result is rounded to
//     bf16. Pixels outside the image keep TMA's zeros: SAME padding is zeros
//     of the transformed input (a*0 + b is not zero). One transform serves
//     all nine taps; a barrier follows it, then the stage's MMAs (the
//     transform of stage s + 1 beside stage s's wgmmas measured no faster
//     in the conv and slower in the wgrad);
//   * A is staged as a tiled halo box and read into registers by ldmatrix
//     at each tap's shift (wgmma's register-A form), not by im2col boxes
//     straight into swizzled shared memory: the register fragment of each
//     warp is mma.sync's, so conv3x3.cu's shifted-halo addressing carries
//     over, one halo box serves all nine taps (im2col mode would copy it
//     nine times), and in the conv one fragment serves three taps (ky
//     reuse);
//   * B comes from shared memory through wgmma descriptors: in the conv
//     the weights [9 taps][16 channels][N] by one 3-D box per chunk (two
//     for N = 128), in the wgrad the dp tile [8 rows][16 pixels][N]; both
//     are N-major (wgmma's transposed-B form, which 16-bit types allow),
//     with the swizzle of their row width (32, 64 or 128 bytes), so the
//     canonical MN-major layout is exactly what TMA writes. The conv's
//     weights stay resident when all chunks fit;
//   * the conv: a CTA of two warpgroups takes a tile of 256 pixels, 8 x 32
//     (warpgroup g the columns 16g..16g + 15) or, where the image is at
//     most 16 wide, 16 x 16 (warpgroup g the rows 8g..8g + 7), which holds
//     a 14 x 14 image whole (77% of its pixels live, against 38% in two
//     8 x 32 tiles); M = 2 x 64 per warpgroup (warp w's rows 2w and 2w + 1
//     of its part), N = up to 128 output channels (halved, down to 32,
//     while the grid would leave SMs idle: at 14^2 a batch of 32 has 32
//     tiles), K = 9 taps x 16-channel chunks; a CTA walks a run of tiles,
//     the epilogue adds the bias, takes the statistics of the fp32 result
//     on in-image pixels and stores bf16 (at N >= 64 through a swizzled
//     shared-memory tile and a TMA store, which clips the tile's
//     out-of-image rows and columns; below, from the registers); the
//     statistics go per tile through shared memory in a fixed order into
//     per-CTA sums, and the CTA that takes the last ticket sums the CTAs'
//     rows in row order, so the sums are bitwise the same from run to run
//     and no column-sum launch follows;
//   * K9 and K11 are the conv in dgrad form with their own epilogues
//     (conv_sm90_kernel's EPI; their arguments in EpiArgs, a kernel
//     argument of its own: A's prologue form measured 10% slower with them
//     in ConvArgs, and A and K8 keep their instantiations unchanged). K9
//     (EPI_SPLIT) writes channel n < Ca to dx_skip at n, the rest to dx_up
//     at n - Ca, whose store map takes the free source slot xb's (both
//     read one source). A 64-wide TMA store box must lie in one half, so
//     the wrapper gives an N tile of 64 or more only where both halves are
//     multiples of 64 (up1's 128 + 128 in two N tiles, up2's 64 + 64 in
//     one), else N tiles of at most 32 (up3's 32 + 32: two, one a half),
//     whose fragments store from the registers, each channel pair into its
//     half;
//   * K11 (EPI_REDUCE): the output mask, hash.cuh's of (seed, ids[b] or b,
//     row, x*F + n), multiplies the fp32 result before it is rounded; then
//     on the ROUNDED output o, against the residual pre (its tile's box by
//     TMA through xb's map slot, issued at the tile's first step so it
//     lands during the MMAs: at N >= 64 into the output tile itself, where
//     each thread reads its pre and then writes its output, below into a
//     tile of its own; per-thread global loads in the epilogue measured no
//     faster than the mma route at 56^2 and 112^2; a per-column a, b, mean
//     and inv staged in shared memory beside the bias, not in registers,
//     as the conv at N = 128 already holds 200-odd), dz = o where a*pre +
//     b (a multiply then an add, no FMA: the plain version's branch) is
//     >= 0 else 0.01 o, xhat = (pre - mean) * inv, and the [sum dz, sum dz
//     * xhat] over in-image pixels take the statistics' place in the
//     per-tile reduction and the last CTA's ticket: K11's column-sum
//     launches go, and its sums are bitwise the same from run to run. This
//     epilogue walks the N tile column by column (n8 block j), so a
//     column's two sums are the only ones live;
//   * the wgrad: dW[tap, c, f] = sum_p x[p + tap, c] dp[p, f] as a split-K
//     GEMM, M = (tap, channel) rows, N = up to 64 output channels, K =
//     pixels. A CTA of three warpgroups holds four channel groups:
//     warpgroup g takes the taps of kernel row ky = g, warp q channel group
//     q, and keeps the three taps kx of its row as three accumulators. So
//     the nine taps fold into M at any channel count; A comes from the
//     halo by ldmatrix.trans at the tap's shift, one k16 step per tile row
//     of 16 pixels. A CTA walks a run of 8 x 16 tiles and writes its
//     partial row, which the fixed-order column sum (colsum_f32) adds (a
//     grid of one row writes dW itself), so dW is bitwise the same from
//     run to run.
//
// The host encodes each tensor map once per distinct set of encode
// arguments (pointer, dims, strides, box, swizzle) and keeps it: a
// CUtensorMap is a pure function of them, and the caching allocator hands
// the same pointers back step after step.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int GC = 16;       // channels of one group: a k16 step
constexpr int STAGES = 4;    // TMA ring depth
constexpr int MAX_SMEM = 232448;
constexpr float kSlope = 0.01f;  // LeakyReLU


// Byte offset of 16-byte half h (channels 8h..8h+7) of pixel p in a halo
// box of 16-channel (32-byte) pixels, as TMA's 32-byte swizzle lays it out
// (address bit 4 ^= bit 7) from a 1024-byte aligned base.
__device__ __forceinline__ uint32_t halo_byte(int p, int h) {
  return (uint32_t)(p * 32 + ((h ^ ((p >> 2) & 1)) << 4));
}

// A channel group g of the pair: source b when g >= na (the groups of
// source a first), and its first channel in that source.
__device__ __forceinline__ bool group_src(int g, int na, int& c) {
  const bool second = g >= na;
  c = GC * (second ? g - na : g);
  return second;
}

// -- the prologue -------------------------------------------------------------

// The operand transform of a conv2 (conv3x3.cu's Prologue): z = lrelu(a[c]
// * x + b[c]) * mask, the mask hash.cuh's hash_keep of (seed, image, row,
// lane = x*C + c) when has_mask; a null a: the identity operand.
struct Pro {
  const float* a;  // [C]
  const float* b;  // [C]
  int has_mask;
  uint32_t seed;
  uint32_t thresh;
  float scale;
  const int* ids;  // [B] each image's index in the global batch, or null
};

// The prologue on 16-byte chunk j of a raw halo box of one 16-channel
// group, in place. The box is bw pixels wide, its pixel (r, col) is image
// pixel (gy0 + r, gx0 + col) of an image whose mask hashes index bi, and
// its first channel is c0. Chunk j holds pixel p = j / 2's channels
// c0 + 8h .. c0 + 8h + 7, h the un-swizzled half (halo_byte's inverse:
// address bit 4 ^= bit 7). A pixel outside the image, or channels at or
// past C (a multiple of 8), keep TMA's zeros: SAME padding is zeros of
// the transformed input.
__device__ __forceinline__ void prologue_chunk(uint8_t* box, int j, int bw,
                                               int gy0, int gx0, int H,
                                               int W, int C, int c0,
                                               const Pro& pro, int bi) {
  const int p = j >> 1;
  const int h = (j & 1) ^ ((p >> 2) & 1);
  const int r = p / bw;
  const int gy = gy0 + r, gx = gx0 + p - r * bw;
  const int c = c0 + 8 * h;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W || c >= C) return;
  uint4* q = reinterpret_cast<uint4*>(box + 16 * j);
  const uint4 u = *q;
  uint32_t v[4] = {u.x, u.y, u.z, u.w};
  // the affine of channels c..c+7 (16-byte aligned: c % 8 == 0)
  const float4* a4 = reinterpret_cast<const float4*>(pro.a + c);
  const float4* b4 = reinterpret_cast<const float4*>(pro.b + c);
  const float4 a0 = __ldg(a4), a1 = __ldg(a4 + 1);
  const float4 b0 = __ldg(b4), b1 = __ldg(b4 + 1);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int sh = 16 * (e & 1);
    float f = bf2f((v[e >> 1] >> sh) & 0xFFFFu);
    // multiply and add rounded separately (no FMA), as the plain version
    // computes them, so both take the same LeakyReLU branch
    f = __fadd_rn(__fmul_rn(f, av[e]), bv[e]);
    f = f >= 0.f ? f : f * kSlope;
    if (pro.has_mask)
      f *= hash_keep(pro.seed, pro.thresh, pro.scale, bi, gy, W * C,
                     gx * C + c + e);
    v[e >> 1] = (v[e >> 1] & ~(0xFFFFu << sh)) | (f2bf(f) << sh);
  }
  *q = make_uint4(v[0], v[1], v[2], v[3]);
}

// -- the conv: A and K8 -------------------------------------------------------

constexpr int CV_TH = 8;   // the wide tile's rows
constexpr int CV_TW = 32;  // and columns: warpgroup g takes 16g..16g+15
constexpr int CV_PIX = CV_TH * CV_TW;  // pixels of either tile
constexpr int CV_A_SLOT = 11264;  // a halo box of either tile, in 1 KB steps
constexpr int CV_NT = 256;

// The conv's pixel tile: 8 x 32, its warpgroups side by side, or TALL,
// 16 x 16, one above the other (an image at most 16 wide); 256 pixels.
template <bool TALL>
struct ConvTile {
  static constexpr int TH = TALL ? 16 : CV_TH;
  static constexpr int TW = TALL ? 16 : CV_TW;
  static constexpr int HW = TW + 2;
  static constexpr int HH = TH + 2;
  static constexpr int A_BYTES = HH * HW * GC * 2;  // 10880 or 10368
  // warpgroup g's first row and first column in the tile
  static __device__ __forceinline__ int row0(int g) { return TALL ? 8 * g : 0; }
  static __device__ __forceinline__ int col0(int g) { return TALL ? 0 : 16 * g; }
};
static_assert(ConvTile<false>::A_BYTES <= CV_A_SLOT &&
                  ConvTile<true>::A_BYTES <= CV_A_SLOT &&
                  ConvTile<true>::TH * ConvTile<true>::TW == CV_PIX,
              "conv tiles");

template <int BN>
struct ConvSmem {
  static constexpr int NJ = BN / 8;                      // n8 blocks
  static constexpr int BNB = BN < 64 ? BN : 64;          // TMA box width
  static constexpr int SW = BNB * 2;                     // B row bytes
  static constexpr int B_BYTES = 9 * GC * BN * 2;        // one chunk
  static constexpr int B_SLOT = (B_BYTES + 1023) / 1024 * 1024;
  static constexpr int HALF = 9 * GC * BNB * 2;          // one 64-wide box
  // [8 warps][BN][2] fp32, and the last CTA's [CV_NT] float4 after it
  static constexpr int RED_BYTES = 8 * BN * 2 * 4 > 16 * 256 ? 8 * BN * 2 * 4
                                                             : 16 * 256;
  // N >= 64 (the operation-bound stages): the rounded tile goes out by
  // TMA from a shared-memory tile, [256 pixels][BNB] a 64-wide half,
  // swizzled as B (measured 9% faster at 28^2 and 56^2 than stores from
  // the registers, which leave the tile's end exposed); N <= 32: from the
  // registers, as the extra tile and barriers cost the byte-bound stages
  // their second CTA an SM (slower at 112^2)
  static constexpr bool TMA_Y = BN >= 64;
  static constexpr int OUT_HALF = CV_PIX * BNB * 2;
  static constexpr int OUT_BYTES = TMA_Y ? CV_PIX * BN * 2 : 0;
  static constexpr int ST = TMA_Y ? 3 : STAGES;  // ring stages
  // RED: K11's per-column constants a, b, mean, inv after the reduction,
  // and its residual's box by TMA: into the output tile at N >= 64 (each
  // thread reads its pre where it then writes its output), below into a
  // tile of its own, [256 pixels][BN] swizzled as B, in the output tile's
  // place before the A ring
  static constexpr int RC_BYTES = 4 * BN * 4;
  static constexpr int PRE_BYTES = TMA_Y ? 0 : CV_PIX * BN * 2;
  // barriers and the bias at the head, then the output tile (RED at N <=
  // 32: pre's tile), the A ring, B, the reduction, the reduce constants
  static constexpr int OUT_OFF = 1024;
  static constexpr int A_OFF = OUT_OFF + OUT_BYTES;
  static int smem(int b_slots, bool red) {
    return 1024 + A_OFF + ST * CV_A_SLOT + b_slots * B_SLOT + RED_BYTES +
           (red ? PRE_BYTES + RC_BYTES : 0);
  }
};

// One source (cb = 0) leaves xb's map free: K9's second output (dx_up)
// and K11's residual pre take it, with boxes as y's
struct ConvMaps {
  CUtensorMap xa, xb, w, y;
};

// K11's output dropout mask: hash.cuh's of (seed, image, row, lane =
// x*F + n), as conv3x3.cu's OutMask
struct OutMask {
  int has_mask;
  uint32_t seed;
  uint32_t thresh;
  float scale;
  const int* ids;  // [B] each image's index in the global batch, or null
};

// K11's reduce against the pre-activation residual (maps.xb: [B,H,W,F]
// bf16) with BN1's per-channel a, b, mean and inv (fp32 [F])
struct Reduce {
  const float* a;
  const float* b;
  const float* m;
  const float* inv;
};

struct ConvArgs {
  const float* bias;    // [F] or null
  uint16_t* y;          // [B,H,W,F] bf16 (at N >= 64 written through maps.y;
                        // SPLIT: [B,H,W,f1])
  float* part;          // [gridDim.x, 2F] or null (no sums)
  float* stats;         // [2F]: the summed [sum, sum^2] (RED: [S0, S1])
  unsigned* counter;    // the ticket, 0 between launches
  Pro pro;              // PRO: xa's prologue (one source)
  int H, W, F, ca, cb;  // cb = 0: one source
  int tiles_x, tiles_per_img, total_tiles, tiles_per_cta;
  int wres;             // the weights of every chunk stay resident
};

// The epilogues of K9 and K11, a kernel argument of their own: ConvArgs
// stays as A and K8 had it (A's prologue form measured 10% slower with
// these fields in ConvArgs, or with ConvArgs a grid constant)
struct EpiArgs {
  uint16_t* y2;  // SPLIT: [B,H,W,F-f1] bf16, channels f1.. (through maps.xb
                 // at N >= 64)
  int f1;        // SPLIT: the split
  OutMask om;    // RED: the output mask
  Reduce red;    // RED: the reduce's operands
};

// The epilogue a conv_sm90_kernel instantiation takes: bias and BN
// statistics (A, K8), K9's split output, or K11's mask and reduce
enum Epi { EPI_STATS = 0, EPI_SPLIT = 1, EPI_REDUCE = 2 };

// N <= 32: two CTAs an SM (at most 128 registers a thread), which the
// byte-bound stages (112^2, 224^2) need to keep enough copies in flight.
// EPI_SPLIT (K9, one identity source): channels from e.f1 go to e.y2;
// EPI_REDUCE (K11, one identity source): the output mask, then the
// BN-backward reduce of the rounded output in place of the statistics.
template <int BN, bool TALL, bool PRO, int EPI>
__global__ void __launch_bounds__(CV_NT, BN <= 32 ? 2 : 1)
conv_sm90_kernel(const __grid_constant__ ConvMaps maps, const ConvArgs a,
                 const EpiArgs e) {
  constexpr bool RED = EPI == EPI_REDUCE, SPLIT = EPI == EPI_SPLIT;
  static_assert(!PRO || EPI == EPI_STATS, "K9 and K11 take identity operands");
  using K = ConvSmem<BN>;
  using T = ConvTile<TALL>;
  constexpr int NJ = K::NJ, SW = K::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [K::ST]
  uint64_t* wbar = full + K::ST;
  uint64_t* pbar = full + K::ST + 1;  // RED: pre's box of the tile
  // the last-CTA flag: dynamic like the rest, as the opt-in of MAX_SMEM
  // bytes leaves no room for static shared memory
  int* s_last = reinterpret_cast<int*>(smem + 48);
  float* s_bias = reinterpret_cast<float*>(smem + 64);  // [BN]
  uint8_t* out_s = smem + K::OUT_OFF;  // RED: pre's box first
  uint8_t* ring_a = smem + K::A_OFF + (RED ? K::PRE_BYTES : 0);
  uint8_t* ring_b = ring_a + K::ST * CV_A_SLOT;
  const int na = (a.ca + GC - 1) / GC;
  const int nch = na + (a.cb + GC - 1) / GC;
  float* red = reinterpret_cast<float*>(
      ring_b + (a.wres ? nch : K::ST) * K::B_SLOT);
  float* s_rc = red + K::RED_BYTES / 4;  // RED: [4][BN] a, b, mean, inv

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;          // warpgroup
  const int w = (tid >> 5) & 3;     // warp of the warpgroup: rows 2w, 2w+1
  const int r0 = T::row0(wg), q0 = T::col0(wg);  // of its part of the tile
  const int lr = lane & 7, lq = lane >> 3;
  const int n0 = blockIdx.y * BN;
  const int H = a.H, W = a.W, F = a.F;
  const int t_begin = blockIdx.x * a.tiles_per_cta;
  const int t_end = min(t_begin + a.tiles_per_cta, a.total_tiles);
  const int nsteps = (t_end - t_begin) * nch;

  auto tile_of = [&](int t, int& b, int& ty0, int& tx0) {
    b = t / a.tiles_per_img;
    const int tt = t - b * a.tiles_per_img;
    ty0 = (tt / a.tiles_x) * T::TH;
    tx0 = (tt % a.tiles_x) * T::TW;
  };
  // weights of chunk k (concat channels from its group) into dst
  auto load_w = [&](uint32_t dst, uint64_t* bar, int k) {
    int c;
    const bool second = group_src(k, na, c);
    const int row = second ? a.ca + c : c;
#pragma unroll
    for (int hb = 0; hb < BN / K::BNB; ++hb)
      tma_3d(dst + hb * K::HALF, &maps.w, bar, n0 + hb * K::BNB, row, 0);
  };
  auto issue = [&](int s) {
    const int st = s % K::ST;
    const int k = s % nch;
    int b, ty0, tx0;
    tile_of(t_begin + s / nch, b, ty0, tx0);
    mbar_expect_tx(&full[st], T::A_BYTES + (a.wres ? 0 : K::B_BYTES));
    int c;
    const bool second = group_src(k, na, c);
    tma_4d(smem_u32(ring_a + st * CV_A_SLOT), second ? &maps.xb : &maps.xa,
           &full[st], c, tx0 - 1, ty0 - 1, b);
    if (!a.wres) load_w(smem_u32(ring_b + st * K::B_SLOT), &full[st], k);
  };
  // PRO: step s's halo box (one source: group s % nch) transformed in
  // place by the CTA's threads
  auto transform = [&](int s) {
    int b, ty0, tx0;
    tile_of(t_begin + s / nch, b, ty0, tx0);
    const int bi = image_index(a.pro.ids, b);
    uint8_t* box = ring_a + (s % K::ST) * CV_A_SLOT;
    for (int j = tid; j < T::A_BYTES / 16; j += CV_NT)
      prologue_chunk(box, j, T::HW, ty0 - 1, tx0 - 1, H, W, a.ca,
                     GC * (s % nch), a.pro, bi);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= K::ST + (RED ? 1 : 0); ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += CV_NT)
    s_bias[i] = a.bias != nullptr && n0 + i < F ? a.bias[n0 + i] : 0.f;
  if constexpr (RED) {
    for (int i = tid; i < BN; i += CV_NT) {
      const bool live = n0 + i < F;
      s_rc[i] = live ? e.red.a[n0 + i] : 0.f;
      s_rc[BN + i] = live ? e.red.b[n0 + i] : 0.f;
      s_rc[2 * BN + i] = live ? e.red.m[n0 + i] : 0.f;
      s_rc[3 * BN + i] = live ? e.red.inv[n0 + i] : 0.f;
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (a.wres) {
      mbar_expect_tx(wbar, nch * K::B_BYTES);
      for (int k = 0; k < nch; ++k)
        load_w(smem_u32(ring_b + k * K::B_SLOT), wbar, k);
    }
    for (int s = 0; s < K::ST && s < nsteps; ++s) issue(s);
  }
  if (a.wres) mbar_wait(wbar, 0);

  float acc[2][BN / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0.f;
  float run0 = 0.f, run1 = 0.f;  // thread tid < BN: column tid's sums

  for (int s = 0; s < nsteps; ++s) {
    const int st = s % K::ST;
    const int k = s % nch;
    if (RED && k == 0 && tid == 0) {
      // the tile's pre box, in flight over its MMAs; at N >= 64 into the
      // output tile, once the last store has read it
      int b, ty0, tx0;
      tile_of(t_begin + s / nch, b, ty0, tx0);
      if constexpr (K::TMA_Y) bulk_wait_read();
      mbar_expect_tx(pbar, CV_PIX * BN * 2);
#pragma unroll
      for (int hb = 0; hb < BN / K::BNB; ++hb)
        tma_4d(smem_u32(out_s + hb * K::OUT_HALF), &maps.xb, pbar,
               n0 + hb * K::BNB, tx0, ty0, b);
    }
    mbar_wait(&full[st], (s / K::ST) & 1);
    if constexpr (PRO) {
      transform(s);
      fence_proxy_async();  // these writes before TMA's next into the slot
      __syncthreads();
    }
    const uint32_t sa = smem_u32(ring_a + st * CV_A_SLOT);
    const uint32_t sb =
        smem_u32(ring_b + (a.wres ? k : st) * K::B_SLOT);
    // halo row 2w + r (of the warpgroup's part) at shift kx is output row
    // 2w + i's A at tap (r - i, kx): four fragments serve both rows at the
    // three ky
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t af[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = (r0 + 2 * w + r) * T::HW + q0 + kx + lr + 8 * (lq & 1);
        ldsm_x4_a(af[r], sa + halo_byte(p, lq >> 1));
      }
      wgmma_fence();
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const uint64_t d =
            desc_mn(sb + (ky * 3 + kx) * GC * SW, K::HALF, SW);
        wgmma_rs<BN>(acc[0], af[ky], d);
        wgmma_rs<BN>(acc[1], af[ky + 1], d);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);

    if (k == nch - 1) {
      // the epilogue: acc[i][4j + 2h + e] is pixel (ty0 + r0 + 2w + i,
      // tx0 + q0 + lane/4 + 8h), channel n0 + 8j + 2(lane%4) + e; the
      // rounded tile goes to out_s and leaves by one TMA store a 64-wide
      // half (which writes only what lies in the image and below F), into
      // y below f1 and y2 from it (K9's split); each column's sums over
      // the warp's pixels in a fixed order (i, then h), then over its
      // lanes by shuffles, go into red: BN statistics [o, o^2] of the fp32
      // result, or RED's [dz, dz * xhat] of the rounded one
      int b, ty0, tx0;
      tile_of(t_begin + s / nch, b, ty0, tx0);
      if constexpr (RED) {
        // pre's box (issued after the last store read out_s) is in
        mbar_wait(pbar, (s / nch) & 1);
        const int bi = image_index(e.om.ids, b);  // the mask's image
        const int wid = tid >> 5;                 // warp of the CTA, 0..7
        // column by column (n8 block j), so a column's two sums are the
        // only ones live
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          const int n = n0 + col;  // F % 8 == 0: n + 1 < F with n
          float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int rr = r0 + 2 * w + i;  // row in the tile
            const int oy = ty0 + rr;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int px = q0 + (lane >> 2) + 8 * h;
              const int ox = tx0 + px;
              const bool live = oy < H && ox < W && n < F;
              float o0 = acc[i][4 * j + 2 * h];
              float o1 = acc[i][4 * j + 2 * h + 1];
              acc[i][4 * j + 2 * h] = 0.f;
              acc[i][4 * j + 2 * h + 1] = 0.f;
              // the pair's place in the output tile and pre's (as below)
              const int pix = rr * T::TW + px;
              const int hc = (col % K::BNB) >> 3;
              const uint32_t off =
                  (col / K::BNB) * K::OUT_HALF + pix * SW +
                  ((hc ^ ((pix * SW >> 7) & (SW / 16 - 1))) << 4) +
                  (col & 7) * 2;
              if (e.om.has_mask && live) {
                o0 *= hash_keep(e.om.seed, e.om.thresh, e.om.scale, bi, oy,
                                W * F, ox * F + n);
                o1 *= hash_keep(e.om.seed, e.om.thresh, e.om.scale, bi, oy,
                                W * F, ox * F + n + 1);
              }
              const uint32_t ob = pack_bf16(o0, o1);
              if (live) {
                // on the rounded output; a*pre + b as a multiply then an
                // add (no FMA), as the plain version, for the same branch
                const uint32_t pp =
                    *reinterpret_cast<const uint32_t*>(out_s + off);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int c = col + e;
                  const float d = bf2f((ob >> (16 * e)) & 0xFFFFu);
                  const float p = bf2f((pp >> (16 * e)) & 0xFFFFu);
                  const float z =
                      __fadd_rn(__fmul_rn(p, s_rc[c]), s_rc[BN + c]);
                  const float dz = z >= 0.f ? d : d * kSlope;
                  s0[e] += dz;
                  s1[e] += dz * ((p - s_rc[2 * BN + c]) * s_rc[3 * BN + c]);
                }
                if constexpr (!K::TMA_Y)
                  *reinterpret_cast<uint32_t*>(
                      a.y + (((size_t)b * H + oy) * W + ox) * F + n) = ob;
              }
              if constexpr (K::TMA_Y)
                *reinterpret_cast<uint32_t*>(out_s + off) = ob;
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int sh = 4; sh < 32; sh <<= 1) {
              s0[e] += __shfl_xor_sync(0xffffffffu, s0[e], sh);
              s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], sh);
            }
          if (lane < 4) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              red[(wid * BN + col + e) * 2] = s0[e];
              red[(wid * BN + col + e) * 2 + 1] = s1[e];
            }
          }
        }
      } else {
        if constexpr (K::TMA_Y) {
          if (tid == 0) bulk_wait_read();  // the last store has read out_s
          __syncthreads();
        }
        float sm[NJ][2], sq[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          sm[j][0] = sm[j][1] = sq[j][0] = sq[j][1] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = r0 + 2 * w + i;  // row in the tile
          const int oy = ty0 + rr;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int px = q0 + (lane >> 2) + 8 * h;
            const int ox = tx0 + px;
            const bool in = oy < H && ox < W;
            const int pix = rr * T::TW + px;  // in the tile
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int col = 8 * j + 2 * (lane & 3);
              const float o0 = acc[i][4 * j + 2 * h] + s_bias[col];
              const float o1 = acc[i][4 * j + 2 * h + 1] + s_bias[col + 1];
              acc[i][4 * j + 2 * h] = 0.f;
              acc[i][4 * j + 2 * h + 1] = 0.f;
              if (in && n0 + col < F) {  // F % 8 == 0: col + 1 < F too
                sm[j][0] += o0;
                sq[j][0] += o0 * o0;
                sm[j][1] += o1;
                sq[j][1] += o1 * o1;
                if constexpr (!K::TMA_Y && SPLIT) {
                  // a pair never straddles the split (e.f1 % 8 == 0)
                  const int n = n0 + col;
                  const size_t gp = ((size_t)b * H + oy) * W + ox;
                  *reinterpret_cast<uint32_t*>(
                      n < e.f1 ? a.y + gp * e.f1 + n
                               : e.y2 + gp * (F - e.f1) + (n - e.f1)) =
                      pack_bf16(o0, o1);
                } else if constexpr (!K::TMA_Y) {
                  *reinterpret_cast<uint32_t*>(
                      a.y + (((size_t)b * H + oy) * W + ox) * F + n0 + col) =
                      pack_bf16(o0, o1);
                }
              }
              if constexpr (K::TMA_Y) {
                // 16-byte chunk (col % BNB) / 8 of row pix, swizzled as TMA
                // lays a row of SW bytes (chunk ^= address bits 7.. of it)
                const int hc = (col % K::BNB) >> 3;
                const uint32_t off =
                    (col / K::BNB) * K::OUT_HALF + pix * SW +
                    ((hc ^ ((pix * SW >> 7) & (SW / 16 - 1))) << 4) +
                    (col & 7) * 2;
                *reinterpret_cast<uint32_t*>(out_s + off) =
                    pack_bf16(o0, o1);
              }
            }
          }
        }
        if (a.part != nullptr) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int off = 4; off < 32; off <<= 1) {
                sm[j][e] += __shfl_xor_sync(0xffffffffu, sm[j][e], off);
                sq[j][e] += __shfl_xor_sync(0xffffffffu, sq[j][e], off);
              }
          if (lane < 4) {
            const int wv = (tid >> 5);  // warp of the CTA, 0..7
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + 2 * lane + e;
                red[(wv * BN + col) * 2] = sm[j][e];
                red[(wv * BN + col) * 2 + 1] = sq[j][e];
              }
          }
        }
      }
      if constexpr (K::TMA_Y) fence_proxy_async();
      __syncthreads();
      if (K::TMA_Y && tid == 0) {
#pragma unroll
        for (int hb = 0; hb < BN / K::BNB; ++hb) {
          const int nb = n0 + hb * K::BNB;  // SPLIT: a box never straddles
          const bool second = SPLIT && nb >= e.f1;  // y2 through maps.xb
          tma_store_4d(second ? &maps.xb : &maps.y,
                       smem_u32(out_s + hb * K::OUT_HALF),
                       second ? nb - e.f1 : nb, tx0, ty0, b);
        }
        bulk_commit();
      }
      if (a.part != nullptr && tid < BN) {
        float t0 = 0.f, t1 = 0.f;
#pragma unroll
        for (int wv = 0; wv < 8; ++wv) {
          t0 += red[(wv * BN + tid) * 2];
          t1 += red[(wv * BN + tid) * 2 + 1];
        }
        run0 += t0;
        run1 += t1;
      }
    }
    __syncthreads();  // every warp is past stage st (and the reduction)
    if (tid == 0 && s + K::ST < nsteps) issue(s + K::ST);
  }

  if (K::TMA_Y && tid == 0) bulk_wait();  // y written before the CTA leaves
  if (a.part == nullptr) return;
  const int row2 = 2 * F;
  if (tid < BN && n0 + tid < F) {
    a.part[(size_t)blockIdx.x * row2 + n0 + tid] = run0;
    a.part[(size_t)blockIdx.x * row2 + F + n0 + tid] = run1;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *s_last = atomicAdd(a.counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  // the last CTA: every column over the CTAs' rows in row order, in Q
  // interleaved slices of rows (slice q takes rows q, q + Q, ...) added in
  // order; 16-byte loads that bypass L1, 16 in flight a thread
  const int rows = gridDim.x, WQ = row2 / 4;
  const float4* p4 = reinterpret_cast<const float4*>(a.part);
  const int Q = WQ >= CV_NT ? 1 : CV_NT / WQ;
  float4* fin = reinterpret_cast<float4*>(red);  // [CV_NT] float4: 4 KB
  for (int j0 = 0; j0 < WQ; j0 += CV_NT) {
    const int q = Q == 1 ? 0 : tid / WQ;
    const int j = Q == 1 ? j0 + tid : tid % WQ;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < Q && j < WQ) {
      int r = q;
      for (; r + 15 * Q < rows; r += 16 * Q) {
        float4 v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          v[i] = __ldcg(p4 + (size_t)(r + i * Q) * WQ + j);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s4.x += v[i].x;
          s4.y += v[i].y;
          s4.z += v[i].z;
          s4.w += v[i].w;
        }
      }
      for (; r < rows; r += Q) {
        const float4 v = __ldcg(p4 + (size_t)r * WQ + j);
        s4.x += v.x;
        s4.y += v.y;
        s4.z += v.z;
        s4.w += v.w;
      }
    }
    fin[tid] = s4;
    __syncthreads();
    if (q == 0 && j < WQ) {
      float4 t = fin[tid];
      for (int qq = 1; qq < Q; ++qq) {
        const float4 u = fin[qq * WQ + j];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      reinterpret_cast<float4*>(a.stats)[j] = t;
    }
    __syncthreads();
  }
  if (tid == 0) *a.counter = 0u;
}

// -- the wgrad: B and K10 -----------------------------------------------------

constexpr int WG_TH = 8;   // tile rows: one k16 step each
constexpr int WG_TW = 16;  // tile columns: the step's 16 pixels
constexpr int WG_HW = WG_TW + 2;
constexpr int WG_A_BYTES = (WG_TH + 2) * WG_HW * GC * 2;  // 5760
constexpr int WG_CHUNKS = WG_A_BYTES / 16;                // 360
constexpr int WG_A_SLOT = 6144;
constexpr int WG_GROUPS = 4;   // channel groups a CTA holds: warp q takes q
constexpr int WG_NT = 384;     // three warpgroups: kernel rows ky = 0, 1, 2

template <int BN>
struct WgradSmem {
  static constexpr int SW = BN * 2;                  // dp row bytes
  static constexpr int D_BYTES = WG_TH * WG_TW * BN * 2;
  static constexpr int STAGE = WG_GROUPS * WG_A_SLOT + D_BYTES;
  static constexpr int SMEM = 1024 + 1024 + STAGES * STAGE;
};

struct WgradMaps {
  CUtensorMap xa, xb, dp;
};

struct WgradArgs {
  float* part;  // [gridDim.x, 9*(ca+cb)*F]: [3,3,ca,F] then [3,3,cb,F]
  Pro pro;      // PRO: xa's prologue (one source)
  int H, W, F, ca, cb;
  int tiles_x, tiles_per_img, total_tiles, tiles_per_cta, cblocks;
};

template <int BN, bool PRO>
__global__ void __launch_bounds__(WG_NT, 1)
wgrad_sm90_kernel(const __grid_constant__ WgradMaps maps,
                  const WgradArgs a) {
  using K = WgradSmem<BN>;
  constexpr int SW = K::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + 1024;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ky = tid >> 7;        // warpgroup: kernel row
  const int q = (tid >> 5) & 3;   // warp: channel group of the CTA
  const int lr = lane & 7, lq = lane >> 3;
  const int cblk = blockIdx.y % a.cblocks;
  const int n0 = (blockIdx.y / a.cblocks) * BN;
  const int na = (a.ca + GC - 1) / GC;
  const int ngroups = na + (a.cb + GC - 1) / GC;
  const int g0 = cblk * WG_GROUPS;
  const int nvalid = min(WG_GROUPS, ngroups - g0);
  const int t_begin = blockIdx.x * a.tiles_per_cta;
  const int t_end = min(t_begin + a.tiles_per_cta, a.total_tiles);
  const int nsteps = t_end - t_begin;

  auto tile_of = [&](int t, int& b, int& ty0, int& tx0) {
    b = t / a.tiles_per_img;
    const int tt = t - b * a.tiles_per_img;
    ty0 = (tt / a.tiles_x) * WG_TH;
    tx0 = (tt % a.tiles_x) * WG_TW;
  };
  auto issue = [&](int s) {
    const int st = s % STAGES;
    int b, ty0, tx0;
    tile_of(t_begin + s, b, ty0, tx0);
    const uint32_t base = smem_u32(ring + st * K::STAGE);
    mbar_expect_tx(&full[st], K::D_BYTES + nvalid * WG_A_BYTES);
    for (int gq = 0; gq < nvalid; ++gq) {
      int c;
      const bool second = group_src(g0 + gq, na, c);
      tma_4d(base + gq * WG_A_SLOT, second ? &maps.xb : &maps.xa, &full[st],
             c, tx0 - 1, ty0 - 1, b);
    }
    tma_4d(base + WG_GROUPS * WG_A_SLOT, &maps.dp, &full[st], n0, tx0, ty0,
           b);
  };
  // PRO: step s's halo boxes (one source) transformed in place by the
  // CTA's threads, chunk j of the groups' boxes in turn
  auto transform = [&](int s) {
    int b, ty0, tx0;
    tile_of(t_begin + s, b, ty0, tx0);
    const int bi = image_index(a.pro.ids, b);
    uint8_t* base = ring + (s % STAGES) * K::STAGE;
    for (int j = tid; j < nvalid * WG_CHUNKS; j += WG_NT) {
      const int gq = j / WG_CHUNKS;
      prologue_chunk(base + gq * WG_A_SLOT, j - gq * WG_CHUNKS, WG_HW,
                     ty0 - 1, tx0 - 1, a.H, a.W, a.ca, GC * (g0 + gq), a.pro,
                     bi);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < STAGES && s < nsteps; ++s) issue(s);

  float acc[3][BN / 2];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[kx][e] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    const int st = s % STAGES;
    mbar_wait(&full[st], (s / STAGES) & 1);
    if constexpr (PRO) {
      transform(s);
      fence_proxy_async();  // these writes before TMA's next into the slot
      __syncthreads();
    }
    const uint32_t base = smem_u32(ring + st * K::STAGE);
    const uint32_t ga = base + q * WG_A_SLOT;
    const uint32_t gd = base + WG_GROUPS * WG_A_SLOT;
    uint32_t af[2][3][4];
#pragma unroll
    for (int y = 0; y < WG_TH; ++y) {
      // A of tap (ky, kx) at tile row y: rows m = the group's 16 channels,
      // k = the row's 16 pixels at the tap's shift, transposed by ldmatrix
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int p = (y + ky) * WG_HW + kx + lr + 8 * (lq >> 1);
        ldsm_x4_t_a(af[y & 1][kx], ga + halo_byte(p, lq & 1));
      }
      wgmma_fence();
      const uint64_t d = desc_mn(gd + y * GC * SW, K::D_BYTES, SW);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) wgmma_rs<BN>(acc[kx], af[y & 1][kx], d);
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one is done: its A is free
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) fence_acc(acc[kx]);
    __syncthreads();  // every warp is past stage st
    if (tid == 0 && s + STAGES < nsteps) issue(s + STAGES);
  }

  // acc[kx][4j + 2h + e]: tap (ky, kx), channel 16 * group + lane/4 + 8h
  // of its source, output channel n0 + 8j + 2(lane%4) + e
  if (q >= nvalid) return;
  int c;
  const bool second = group_src(g0 + q, na, c);
  const int cs = second ? a.cb : a.ca;
  const size_t C = (size_t)a.ca + a.cb;
  float* row = a.part + (size_t)blockIdx.x * 9 * C * a.F +
               (second ? (size_t)9 * a.ca * a.F : 0);
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = c + (lane >> 2) + 8 * h;
      if (ci >= cs) continue;
      float* out = row + ((size_t)(ky * 3 + kx) * cs + ci) * a.F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int f = n0 + 8 * j + 2 * (lane & 3);
        if (f < a.F)
          *reinterpret_cast<float2*>(out + f) =
              make_float2(acc[kx][4 * j + 2 * h], acc[kx][4 * j + 2 * h + 1]);
      }
    }
}

// -- host --------------------------------------------------------------------

// An NHWC activation [B,H,W,C] as halo boxes of one channel group
int encode_halo(CUtensorMap* map, const void* x, int B, int H, int W, int C,
                int box_w, int box_h) {
  const uint64_t d[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint32_t box[4] = {GC, (uint32_t)box_w, (uint32_t)box_h, 1};
  return encode(map, x, 4, d, box);
}

// The two sources' halo maps; one source (cb = 0): xb is xa's map, which
// the kernels never read then
int encode_sources(CUtensorMap* ma, CUtensorMap* mb, const void* xa,
                   const void* xb, int B, int H, int W, int ca, int cb,
                   int box_w, int box_h) {
  int err = encode_halo(ma, xa, B, H, W, ca, box_w, box_h);
  if (!err && cb > 0) err = encode_halo(mb, xb, B, H, W, cb, box_w, box_h);
  if (!err && cb == 0) *mb = *ma;
  return err;
}

template <int BN, bool TALL, bool PRO, int EPI>
int launch_conv(const ConvMaps& maps, const ConvArgs& args,
                const EpiArgs& epi, int ctas, int ntn, int b_slots,
                cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_sm90_kernel<BN, TALL, PRO, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  (void)attr;  // a refusal shows as the launch's error
  conv_sm90_kernel<BN, TALL, PRO, EPI>
      <<<dim3(ctas, ntn), CV_NT,
         ConvSmem<BN>::smem(b_slots, EPI == EPI_REDUCE), stream>>>(maps, args,
                                                                  epi);
  return (int)cudaGetLastError();
}

// The instantiation of N tile BN for the tile, the prologue (A's conv2)
// and the epilogue (K9's split, K11's reduce); the tall tile is built for
// N >= 32 only (the wrappers pick it at F >= 32)
template <int BN, bool TALL>
int launch_conv_tile(const ConvMaps& maps, const ConvArgs& args,
                     const EpiArgs& epi, bool pro, int mode, int ctas,
                     int ntn, int b_slots, cudaStream_t s) {
  if (pro)
    return launch_conv<BN, TALL, true, EPI_STATS>(maps, args, epi, ctas, ntn,
                                                  b_slots, s);
  switch (mode) {
    case EPI_SPLIT:
      return launch_conv<BN, TALL, false, EPI_SPLIT>(maps, args, epi, ctas,
                                                     ntn, b_slots, s);
    case EPI_REDUCE:
      return launch_conv<BN, TALL, false, EPI_REDUCE>(maps, args, epi, ctas,
                                                      ntn, b_slots, s);
    default:
      return launch_conv<BN, TALL, false, EPI_STATS>(maps, args, epi, ctas,
                                                     ntn, b_slots, s);
  }
}

template <int BN>
int launch_conv_bn(const ConvMaps& maps, const ConvArgs& args,
                   const EpiArgs& epi, bool tall, bool pro, int mode,
                   int ctas, int ntn, int b_slots, cudaStream_t s) {
  if constexpr (BN >= 32) {
    if (tall)
      return launch_conv_tile<BN, true>(maps, args, epi, pro, mode, ctas, ntn,
                                        b_slots, s);
  }
  if (tall) return (int)cudaErrorInvalidValue;
  return launch_conv_tile<BN, false>(maps, args, epi, pro, mode, ctas, ntn,
                                     b_slots, s);
}

template <int BN, bool PRO>
int launch_wgrad(const WgradMaps& maps, const WgradArgs& args, int ctas,
                 int nnb, cudaStream_t stream) {
  using K = WgradSmem<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_sm90_kernel<BN, PRO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::SMEM);
  (void)attr;
  wgrad_sm90_kernel<BN, PRO><<<dim3(ctas, args.cblocks * nnb), WG_NT, K::SMEM,
                               stream>>>(maps, args);
  return (int)cudaGetLastError();
}

Pro make_pro(const void* pa, const void* pb, int has_mask, unsigned seed,
             unsigned thresh, float scale, const void* ids) {
  return Pro{static_cast<const float*>(pa), static_cast<const float*>(pb),
             has_mask, seed, thresh, scale, static_cast<const int*>(ids)};
}

}  // namespace

extern "C" {

// The wgmma kernels' pixel tiles (rows, columns): the conv's wide (tall =
// 0) or tall tile, and the wgrad's, which the Python geometry
// (ops/conv_block.py conv_grid, pair_conv_grid, wgrad_grid,
// pair_wgrad_grid) sizes the grids and buffers by.
int hpfg_conv_sm90_tile_h(int tall) {
  return tall ? ConvTile<true>::TH : ConvTile<false>::TH;
}
int hpfg_conv_sm90_tile_w(int tall) {
  return tall ? ConvTile<true>::TW : ConvTile<false>::TW;
}
int hpfg_pair_wgrad_tile_h() { return WG_TH; }
int hpfg_pair_wgrad_tile_w() { return WG_TW; }

// A, K8, K9 and K11 on wgmma: xa [B,H,W,ca] and xb [B,H,W,cb] (cb = 0:
// one source, xb unread), w [3,3,ca+cb,F] bf16 (16-byte aligned; ca, cb,
// F multiples of 8), bias [F] fp32 or null; y [B,H,W,f1] and y2
// [B,H,W,F-f1] bf16, the output's channels below f1 and from it (f1 = F:
// y alone, y2 unread; at bn >= 64, f1 and F - f1 multiples of 64, so no
// 64-wide store box straddles them); part [ctas, 2F] fp32, stats [2F]
// fp32 and counter (a zeroed uint32 the kernel leaves zeroed) or all null
// (no sums); pa, pb (fp32 [ca]), has_mask, seed, thresh, scale, ids: xa's
// prologue (one source only), pa null for none; om_*: the output mask
// (K11; om_has 0 for none); pre [B,H,W,F] bf16 and ra, rb, rm, rinv fp32
// [F]: K11's reduce, whose [S0, S1] take the statistics' place (one
// identity source, no bias, sums required), pre null for none. bn: the N
// tile (16, 32, 64 or 128; ntn = ceil(F / bn) tiles over grid.y); tall:
// the 16 x 16 tile (bn >= 32), else 8 x 32; a CTA takes tiles_per_cta
// tiles in order, ctas of them; wres: every chunk's weights stay resident
// (sized by the caller).
int hpfg_conv_sm90(const void* xa, const void* xb, const void* w,
                   const void* bias, void* y, void* y2, void* part,
                   void* stats, void* counter, const void* pa, const void* pb,
                   int has_mask, unsigned seed, unsigned thresh, float scale,
                   const void* ids, int om_has, unsigned om_seed,
                   unsigned om_thresh, float om_scale, const void* om_ids,
                   const void* pre, const void* ra, const void* rb,
                   const void* rm, const void* rinv, int B, int H, int W,
                   int ca, int cb, int F, int f1, int bn, int tall,
                   int tiles_per_cta, int ctas, int wres, void* stream) {
  const int th = hpfg_conv_sm90_tile_h(tall), tw = hpfg_conv_sm90_tile_w(tall);
  const int tiles_x = (W + tw - 1) / tw;
  const int tiles_per_img = tiles_x * ((H + th - 1) / th);
  const bool pro = pa != nullptr, red = pre != nullptr;
  const int bnb = bn < 64 ? bn : 64;
  if ((pro || red) && cb != 0) return (int)cudaErrorInvalidValue;
  if (red && (pro || part == nullptr || bias != nullptr))
    return (int)cudaErrorInvalidValue;
  if (f1 <= 0 || f1 > F ||
      (f1 < F && (y2 == nullptr || red || cb != 0 ||
                  (bn >= 64 && (f1 % bnb != 0 || (F - f1) % bnb != 0)))))
    return (int)cudaErrorInvalidValue;
  const ConvArgs args{static_cast<const float*>(bias),
                      static_cast<uint16_t*>(y),
                      static_cast<float*>(part),
                      static_cast<float*>(stats),
                      static_cast<unsigned*>(counter),
                      make_pro(pa, pb, has_mask, seed, thresh, scale, ids),
                      H, W, F, ca, cb, tiles_x, tiles_per_img,
                      B * tiles_per_img, tiles_per_cta, wres};
  const EpiArgs epi{static_cast<uint16_t*>(y2), f1,
                    OutMask{om_has, om_seed, om_thresh, om_scale,
                            static_cast<const int*>(om_ids)},
                    Reduce{static_cast<const float*>(ra),
                           static_cast<const float*>(rb),
                           static_cast<const float*>(rm),
                           static_cast<const float*>(rinv)}};
  const int mode = red ? EPI_REDUCE : f1 < F ? EPI_SPLIT : EPI_STATS;
  ConvMaps maps;
  int err = encode_sources(&maps.xa, &maps.xb, xa, xb, B, H, W, ca, cb,
                           tw + 2, th + 2);
  if (!err) {
    const uint64_t d[3] = {(uint64_t)F, (uint64_t)(ca + cb), 9};
    const uint32_t box[3] = {(uint32_t)bnb, GC, 9};
    err = encode(&maps.w, w, 3, d, box);
  }
  const uint32_t ybox[4] = {(uint32_t)bnb, (uint32_t)tw, (uint32_t)th, 1};
  if (!err) {
    const uint64_t d[4] = {(uint64_t)f1, (uint64_t)W, (uint64_t)H,
                           (uint64_t)B};
    err = encode(&maps.y, y, 4, d, ybox);
  }
  // one source: K9's dx_up or K11's pre in xb's place
  if (!err && f1 < F) {
    const uint64_t d[4] = {(uint64_t)(F - f1), (uint64_t)W, (uint64_t)H,
                           (uint64_t)B};
    err = encode(&maps.xb, y2, 4, d, ybox);
  }
  if (!err && red) {
    const uint64_t d[4] = {(uint64_t)F, (uint64_t)W, (uint64_t)H,
                           (uint64_t)B};
    err = encode(&maps.xb, pre, 4, d, ybox);
  }
  if (err) return err;
  const int ntn = (F + bn - 1) / bn;
  const int nch = (ca + GC - 1) / GC + (cb + GC - 1) / GC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16:
      return launch_conv_bn<16>(maps, args, epi, tall, pro, mode, ctas,
                                ntn, wres ? nch : ConvSmem<16>::ST, s);
    case 32:
      return launch_conv_bn<32>(maps, args, epi, tall, pro, mode, ctas,
                                ntn, wres ? nch : ConvSmem<32>::ST, s);
    case 64:
      return launch_conv_bn<64>(maps, args, epi, tall, pro, mode, ctas,
                                ntn, wres ? nch : ConvSmem<64>::ST, s);
    case 128:
      return launch_conv_bn<128>(maps, args, epi, tall, pro, mode, ctas,
                                 ntn, wres ? nch : ConvSmem<128>::ST, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B and K10 on wgmma: xa, xb as hpfg_conv_sm90's (cb = 0: one source),
// dp [B,H,W,F] bf16, part [ctas, 9*(ca+cb)*F] fp32 ([3,3,ca,F] then
// [3,3,cb,F] a row), summed by hpfg_colsum_f32 (one row: dW itself); pa
// .. ids: xa's prologue as hpfg_conv_sm90's. bn: the N tile (16, 32 or
// 64); cblocks: blocks of four 16-channel groups (those of xa, then
// xb's); grid (ctas, cblocks x ceil(F / bn)); a CTA takes tiles_per_cta
// 8 x 16 tiles in order.
int hpfg_wgrad_sm90(const void* xa, const void* xb, const void* dp,
                    void* part, const void* pa, const void* pb, int has_mask,
                    unsigned seed, unsigned thresh, float scale,
                    const void* ids, int B, int H, int W, int ca, int cb,
                    int F, int bn, int tiles_per_cta, int ctas, int cblocks,
                    void* stream) {
  const int tiles_x = (W + WG_TW - 1) / WG_TW;
  const int tiles_per_img = tiles_x * ((H + WG_TH - 1) / WG_TH);
  if (pa != nullptr && cb != 0) return (int)cudaErrorInvalidValue;
  const WgradArgs args{static_cast<float*>(part),
                       make_pro(pa, pb, has_mask, seed, thresh, scale, ids),
                       H, W, F, ca, cb, tiles_x, tiles_per_img,
                       B * tiles_per_img, tiles_per_cta, cblocks};
  WgradMaps maps;
  int err = encode_sources(&maps.xa, &maps.xb, xa, xb, B, H, W, ca, cb,
                           WG_HW, WG_TH + 2);
  if (!err) {
    const uint64_t d[4] = {(uint64_t)F, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint32_t box[4] = {(uint32_t)bn, WG_TW, WG_TH, 1};
    err = encode(&maps.dp, dp, 4, d, box);
  }
  if (err) return err;
  const int nnb = (F + bn - 1) / bn;
  const bool pro = pa != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16:
      return pro ? launch_wgrad<16, true>(maps, args, ctas, nnb, s)
                 : launch_wgrad<16, false>(maps, args, ctas, nnb, s);
    case 32:
      return pro ? launch_wgrad<32, true>(maps, args, ctas, nnb, s)
                 : launch_wgrad<32, false>(maps, args, ctas, nnb, s);
    case 64:
      return pro ? launch_wgrad<64, true>(maps, args, ctas, nnb, s)
                 : launch_wgrad<64, false>(maps, args, ctas, nnb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
