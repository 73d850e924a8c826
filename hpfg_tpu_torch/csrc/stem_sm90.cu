// K12: the UNet stem conv in bf16 on Hopper (sm_90a): a 3x3 SAME conv from
// C = 1 or 3 input channels to F = 16 or 32, plus bias, rounded to bf16
// once, with the per-channel [sum, sum^2] of the fp32 result (the BN
// statistics of the stem's conv1) summed inside the kernel.
//
// Replaces (hpfg_tpu/ops/pallas/conv_block.py): _conv_stats_c1_kernel
// (K12, body :746, pallas_call :872, dispatched at :1067), the C = 1 stem,
// which expands the packed C = 1 rows onto the lane structure in VMEM; the
// C = 3 stems of the LIDC, ISIC and Building configs take the same kernel.
// Launcher hpfg_stem_sm90; ops/conv_block.py conv_route sends a bf16 stem
// here (form "conv", C in {1, 3}, F in {16, 32}, W*C*2 a multiple of 16
// bytes, 16-byte aligned bases: the "stem" route); any other stem keeps
// conv3x3.cu's mma.sync kernel.
//
// What bounds it on an H100: bytes. The ACDC stem (32 x 224^2, 1 -> 16)
// reads 3.2 MB and writes 51.4 MB for 0.46 GFLOP: 16 us of HBM traffic
// against under 1 us of tensor-core work. The mma.sync route padded C to
// one 16-channel chunk per tap (15/16 of every product multiplied zeros),
// staged its halo one element at a time, and wrote per-tile statistics
// rows that a second launch (colsum) read back.
//
// What the design does about it:
//   * taps packed into K: each pixel's 3x3xC patch is one K row of 9C =
//     9 or 27 values, padded to 16 or 32, against the weights [9C][F]
//     (HWIO flattened: row k = (ky, kx, c), exactly that order) padded to
//     match. One m64 n16/n32 k16 wgmma (C = 1) or two (C = 3) gives 64
//     pixels x F channels. The A operand is built in registers (wgmma's
//     register-A form, mma.sync's fragment layout): each thread reads its
//     fragment's K entries straight from the staged halo at per-thread
//     offsets fixed at the start, so no packed copy goes through shared
//     memory; B, the packed weights, is N-major in shared memory with the
//     swizzle of its row width (32 or 64 bytes), written once per CTA.
//     An FFMA form (one pixel and 16 channels a thread, 9C x 16 fp32 FMAs
//     on the CUDA cores), the alternative FLOPs this small allow, timed
//     1.5-3x slower than this one (scripts/tune_conv_kernels.py, PERF.md)
//     and was dropped;
//   * the halo by TMA: x viewed as [B, H, W*C] (3-D, so a box never
//     crosses images), one box of (TH + 2) rows x (TW + 16) C elements a
//     tile (TW = 32 columns, TH = 32 rows at F = 16, 16 at F = 32), 8
//     pixels of margin each side so every box starts 16-byte aligned in
//     the row; TMA fills what lies outside the image (left and top at
//     negative coordinates) with zeros: the SAME padding. Unswizzled:
//     the box lands row after row;
//   * the output through shared memory and a TMA store (4-D map [F, W, H,
//     B], box [F, TW, TH, 1], 32 KB a tile), which clips the columns and
//     rows past the image; two output buffers and four halo buffers, and
//     a persistent grid (two CTAs an SM) walking tiles i, i + grid, ...:
//     the halo loads of the next three tiles are in flight during this
//     tile's compute, and this tile's store drains while the next one
//     computes;
//   * statistics in the kernel: each thread sums its columns' [S, S^2]
//     over its in-image pixels in a fixed order, warp shuffles and the
//     CTA's warps (in order) give a CTA partial row, and the CTA that
//     takes the last ticket sums the rows in row order (as
//     conv_sm90_kernel does), so no column-sum launch follows and the
//     sums are bitwise the same from run to run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int ST_NT = 256;   // two warpgroups
constexpr int ST_TW = 32;    // tile columns
constexpr int ST_PAD = 8;    // box columns each side of the tile
constexpr int ST_WARPS = ST_NT / 32;
constexpr int ST_HALOS = 4;  // halo buffers: loads of 3 tiles ahead in flight

template <int C, int N>
struct StemTile {
  static constexpr int TH = 512 / N;           // 32 rows at N = 16, 16 at 32
  static constexpr int PIX = TH * ST_TW;       // 1024 or 512 pixels
  static constexpr int MB = PIX / 64;          // m64 blocks of a tile
  static constexpr int BW = (ST_TW + 2 * ST_PAD) * C;  // box row elements
  static constexpr int BH = TH + 2;
  static constexpr int HALO_BYTES = BH * BW * 2;
  static constexpr int HALO_SLOT = (HALO_BYTES + 1023) / 1024 * 1024;
  static constexpr int OUT_BYTES = PIX * N * 2;  // 32 KB
  static constexpr int K = 9 * C;
  static constexpr int KP = K <= 16 ? 16 : 32;   // K padded to k16 steps
  static constexpr int KS = KP / 16;
  static constexpr int SW = N * 2;               // B row bytes
  static constexpr int W_BYTES = KP * SW;
  static constexpr int OFF_HALO = 2 * OUT_BYTES;
  static constexpr int OFF_W = OFF_HALO + ST_HALOS * HALO_SLOT;
  static constexpr int OFF_BIAS = OFF_W + (W_BYTES + 1023) / 1024 * 1024;
  static constexpr int OFF_RED = OFF_BIAS + N * 4;
  static constexpr int OFF_BAR = OFF_RED + ST_WARPS * 2 * N * 4;
  static constexpr int OFF_LAST = OFF_BAR + 8 * ST_HALOS;
  static constexpr int SMEM = 1024 + OFF_LAST + 16;  // 1024: base alignment
};

struct StemArgs {
  const uint16_t* w;   // [9C][F] bf16: HWIO [3,3,C,F] flattened
  const float* bias;   // [F] or null
  float* part;         // [gridDim.x][2F] CTA partial rows, or null: no stats
  float* stats;        // [2F]: [sum, sum^2]
  unsigned* counter;   // the ticket, 0 between launches
  int H, W, tiles_x, tiles_y, tiles;
};

// byte of 16-byte chunk h of row k in an N-major operand of SW-byte rows
// with the swizzle of its row width, from a 1024-byte aligned base
template <int SW>
__device__ __forceinline__ int swz_byte(int k, int h) {
  return k * SW + ((h ^ ((k * SW >> 7) & (SW / 16 - 1))) << 4);
}

template <int C, int N>
__global__ void __launch_bounds__(ST_NT, 2)
    stem_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap ymap,
                     const StemArgs a) {
  using T = StemTile<C, N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + T::OFF_BAR);
  float* bias_s = reinterpret_cast<float*>(sm + T::OFF_BIAS);
  float* red = reinterpret_cast<float*>(sm + T::OFF_RED);
  int* s_last = reinterpret_cast<int*>(sm + T::OFF_LAST);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stats = a.part != nullptr;

  if (tid == 0) {
    for (int h = 0; h < ST_HALOS; ++h) mbar_init(&bar[h], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the packed B: rows k < 9C from the weights, zero rows up to KP
  for (int i = tid; i < T::KP * (N / 8); i += ST_NT) {
    const int k = i / (N / 8), h = i % (N / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < T::K) v = *reinterpret_cast<const uint4*>(a.w + k * N + h * 8);
    *reinterpret_cast<uint4*>(sm + T::OFF_W + swz_byte<T::SW>(k, h)) = v;
  }
  for (int i = tid; i < N; i += ST_NT)
    bias_s[i] = a.bias != nullptr ? a.bias[i] : 0.f;
  fence_proxy_async();  // B is read by wgmma
  __syncthreads();

  const int per_img = a.tiles_x * a.tiles_y;
  auto origin = [&](int t, int& b, int& y0, int& x0) {
    b = t / per_img;
    const int r = t - b * per_img;
    y0 = r / a.tiles_x * T::TH;
    x0 = r % a.tiles_x * ST_TW;
  };
  auto issue = [&](int t, int buf) {
    int b, y0, x0;
    origin(t, b, y0, x0);
    mbar_expect_tx(&bar[buf], T::HALO_BYTES);
    tma_3d(smem_u32(sm + T::OFF_HALO + buf * T::HALO_SLOT), &xmap, &bar[buf],
           (x0 - ST_PAD) * C, y0 - 1, b);
  };

  // per-thread statistics of its columns: columns 8j + 2(lane % 4) + e of
  // its fragments
  constexpr int NS = N / 4;
  float s0[NS], s1[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s0[i] = s1[i] = 0.f;

  // the fragment offsets: register j of k step s holds K
  // entries k = 16s + 2(lane % 4) + (j >= 2 ? 8 : 0) + {0, 1} (mma.sync's A
  // layout), each an offset into the halo from the pixel's centre tap (of
  // either sign), or NO_TAP past 9C (zero)
  constexpr int NO_TAP = -(1 << 30);
  const int g = lane >> 2, t4 = lane & 3;
  int offk[T::KS][4];
#pragma unroll
  for (int s = 0; s < T::KS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * s + 2 * t4 + (j >> 1) * 8 + (j & 1);
      const int tap = k / C, ch = k % C;
      offk[s][j] = k < T::K ? (tap / 3 - 1) * T::BW + (tap % 3 - 1) * C + ch
                            : NO_TAP;
    }

  if (tid == 0)
    for (int h = 0; h < ST_HALOS - 1; ++h)
      if (blockIdx.x + h * gridDim.x < a.tiles)
        issue(blockIdx.x + h * gridDim.x, h);
  int i = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i) {
    const int buf = i & 1, hb = i % ST_HALOS;
    if (tid == 0) {
      // tile i + 3's halo into the buffer tile i - 1 left
      const int ahead = t + (ST_HALOS - 1) * (int)gridDim.x;
      if (ahead < a.tiles) issue(ahead, (i + ST_HALOS - 1) % ST_HALOS);
      bulk_wait_read_1();  // the store of tile i - 2 has left out[buf]
    }
    int b, y0, x0;
    origin(t, b, y0, x0);
    mbar_wait(&bar[hb], (i / ST_HALOS) & 1);
    __syncthreads();
    const uint16_t* halo =
        reinterpret_cast<const uint16_t*>(sm + T::OFF_HALO + hb * T::HALO_SLOT);
    uint8_t* out = sm + buf * T::OUT_BYTES;
    // the halo element of pixel p's centre tap, channel 0
    auto centre = [&](int p) {
      return (p / ST_TW + 1) * T::BW + (p % ST_TW + ST_PAD) * C;
    };
    auto inside = [&](int p) {
      return y0 + p / ST_TW < a.H && x0 + p % ST_TW < a.W;
    };

    // warpgroup wg takes m64 blocks wg, wg + 2, ..., GB at a time (the
    // accumulators of GB blocks live at once); warp wq of it rows 16 wq ..
    // 16 wq + 15 of each block
    constexpr int GB = N == 16 ? 4 : 2;
    constexpr int NJ = N / 8;
    const int wg = warp >> 2, wq = warp & 3;
    const uint32_t wb = smem_u32(sm + T::OFF_W);
#pragma unroll 1
    for (int m0 = wg; m0 < T::MB; m0 += 2 * GB) {
      float acc[GB][N / 2];
      uint32_t af[GB][T::KS][4];
#pragma unroll
      for (int q = 0; q < GB; ++q) {
        const int p0 = 64 * (m0 + 2 * q) + 16 * wq + g;
        const int c0 = centre(p0), c1 = centre(p0 + 8);
#pragma unroll
        for (int s = 0; s < T::KS; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // registers 0, 2: row g; 1, 3: row g + 8
            const int base = (j & 1) ? c1 : c0;
            const int* o = &offk[s][(j >> 1) * 2];
            const uint32_t lo = o[0] != NO_TAP ? halo[base + o[0]] : 0u;
            const uint32_t hi = o[1] != NO_TAP ? halo[base + o[1]] : 0u;
            af[q][s][j] = lo | (hi << 16);
          }
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[q][e] = 0.f;
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < GB; ++q)
#pragma unroll
        for (int s = 0; s < T::KS; ++s)
          wgmma_rs<N>(acc[q], af[q][s],
                      desc_mn(wb + s * 16 * T::SW, 16 * T::SW, T::SW));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < GB; ++q) fence_acc(acc[q]);
#pragma unroll
      for (int q = 0; q < GB; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 64 * (m0 + 2 * q) + 16 * wq + g + 8 * h;
          const bool in_img = stats && inside(p);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int n = 8 * j + 2 * t4;
            const float v0 = acc[q][4 * j + 2 * h] + bias_s[n];
            const float v1 = acc[q][4 * j + 2 * h + 1] + bias_s[n + 1];
            if (in_img) {
              s0[2 * j] += v0;
              s1[2 * j] += v0 * v0;
              s0[2 * j + 1] += v1;
              s1[2 * j + 1] += v1 * v1;
            }
            *reinterpret_cast<uint32_t*>(out + (p * N + n) * 2) =
                pack_bf16(v0, v1);
          }
        }
    }
    fence_proxy_async();  // out[buf] is read by the TMA store
    __syncthreads();
    if (tid == 0) {
      tma_store_4d(&ymap, smem_u32(out), 0, x0, y0, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();  // y written, out free, before the CTA leaves
  if (!stats) return;

  // the CTA's partial row: each thread's columns over the lanes that hold
  // the same columns (shuffles in a fixed tree), then the warps in order
  constexpr int XMIN = 4;  // lanes apart with other columns
#pragma unroll
  for (int i2 = 0; i2 < NS; ++i2)
#pragma unroll
    for (int off = 16; off >= XMIN; off >>= 1) {
      s0[i2] += __shfl_xor_sync(0xffffffffu, s0[i2], off);
      s1[i2] += __shfl_xor_sync(0xffffffffu, s1[i2], off);
    }
  __syncthreads();
  if (lane < XMIN) {
#pragma unroll
    for (int i2 = 0; i2 < NS; ++i2) {
      const int n = 8 * (i2 >> 1) + 2 * lane + (i2 & 1);
      red[(warp * 2) * N + n] = s0[i2];
      red[(warp * 2 + 1) * N + n] = s1[i2];
    }
  }
  __syncthreads();
  const int F = N;
  if (tid < 2 * N) {
    const int e = tid / N, n = tid % N;
    float v = 0.f;
#pragma unroll
    for (int wv = 0; wv < ST_WARPS; ++wv) v += red[(wv * 2 + e) * N + n];
    a.part[(size_t)blockIdx.x * 2 * F + e * F + n] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  // the last CTA: every column over the CTAs' rows in row order, in Q
  // interleaved slices of rows (slice q takes rows q, q + Q, ...) added in
  // order; 16-byte loads that bypass L1, 16 in flight a thread
  const int rows = gridDim.x, WQ = 2 * F / 4, Q = ST_NT / WQ;
  const float4* p4 = reinterpret_cast<const float4*>(a.part);
  float4* fin = reinterpret_cast<float4*>(sm);  // [ST_NT] float4 in out[0]
  const int q = tid / WQ, j = tid % WQ;
  float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
  int r = q;
  for (; r + 15 * Q < rows; r += 16 * Q) {
    float4 v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = __ldcg(p4 + (size_t)(r + u * Q) * WQ + j);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      s4.x += v[u].x;
      s4.y += v[u].y;
      s4.z += v[u].z;
      s4.w += v[u].w;
    }
  }
  for (; r < rows; r += Q) {
    const float4 v = __ldcg(p4 + (size_t)r * WQ + j);
    s4.x += v.x;
    s4.y += v.y;
    s4.z += v.z;
    s4.w += v.w;
  }
  fin[tid] = s4;
  __syncthreads();
  if (q == 0) {
    float4 t = fin[j];
    for (int qq = 1; qq < Q; ++qq) {
      const float4 u = fin[qq * WQ + j];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    reinterpret_cast<float4*>(a.stats)[j] = t;
  }
  if (tid == 0) *a.counter = 0u;
}

template <int C, int N>
int launch_stem(const CUtensorMap& xm, const CUtensorMap& ym,
                const StemArgs& args, int ctas, cudaStream_t s) {
  constexpr int SMEM = StemTile<C, N>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      stem_sm90_kernel<C, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  (void)attr;  // a refusal shows as the launch's error
  stem_sm90_kernel<C, N><<<ctas, ST_NT, SMEM, s>>>(xm, ym, args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The stem kernel's pixel tile (rows, columns) at F output channels, which
// ops/conv_block.py stem_grid sizes the grid and partial rows by.
int hpfg_stem_tile_h(int f) { return f == 32 ? 16 : 32; }
int hpfg_stem_tile_w() { return ST_TW; }

// x [B,H,W,C] bf16 (C 1 or 3, W*C*2 a multiple of 16), w [3,3,C,F] bf16
// (F 16 or 32), bias [F] fp32 or null, y [B,H,W,F] bf16, all 16-byte
// aligned; part [ctas, 2F] fp32, stats [2F] fp32 and counter (a zeroed
// uint32 the kernel leaves zeroed), or all null: no statistics. ctas: the
// persistent grid (at most the tiles).
int hpfg_stem_sm90(const void* x, const void* w, const void* bias, void* y,
                   void* part, void* stats, void* counter, int B, int H,
                   int W, int C, int F, int ctas, void* stream) {
  if ((C != 1 && C != 3) || (F != 16 && F != 32) || (W * C * 2) % 16 ||
      ctas < 1 || (reinterpret_cast<uintptr_t>(x) |
                   reinterpret_cast<uintptr_t>(w) |
                   reinterpret_cast<uintptr_t>(y)) & 15)
    return (int)cudaErrorInvalidValue;
  const int th = hpfg_stem_tile_h(F);
  StemArgs args;
  args.w = static_cast<const uint16_t*>(w);
  args.bias = static_cast<const float*>(bias);
  args.part = static_cast<float*>(part);
  args.stats = static_cast<float*>(stats);
  args.counter = static_cast<unsigned*>(counter);
  args.H = H;
  args.W = W;
  args.tiles_x = (W + ST_TW - 1) / ST_TW;
  args.tiles_y = (H + th - 1) / th;
  args.tiles = B * args.tiles_x * args.tiles_y;
  CUtensorMap xm, ym;
  const uint64_t dx[3] = {(uint64_t)W * C, (uint64_t)H, (uint64_t)B};
  const uint32_t bx[3] = {(uint32_t)((ST_TW + 2 * ST_PAD) * C),
                          (uint32_t)(th + 2), 1};
  int err = encode(&xm, x, 3, dx, bx, false);
  if (err) return err;
  const uint64_t dy[4] = {(uint64_t)F, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint32_t by[4] = {(uint32_t)F, ST_TW, (uint32_t)th, 1};
  err = encode(&ym, y, 4, dy, by, false);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1)
    return F == 16 ? launch_stem<1, 16>(xm, ym, args, ctas, s)
                   : launch_stem<1, 32>(xm, ym, args, ctas, s);
  return F == 16 ? launch_stem<3, 16>(xm, ym, args, ctas, s)
                 : launch_stem<3, 32>(xm, ym, args, ctas, s);
}

}  // extern "C"
