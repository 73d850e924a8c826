// Window multi-head attention of the SwinUNet in bf16 on Hopper's own
// tensor-core path: wgmma (warpgroup MMA, fp32 sums in registers) fed by
// TMA (tensor-map bulk copies into shared memory, completion on mbarriers)
// and written back by TMA stores. sm_90a only.
//
// Replaces (hpfg_tpu/ops/pallas/window_attention.py), for the bf16 calls
// that ops/window_attention.py attn_route sends here (head width D of 16,
// 32 or 64, L <= 64, 16-byte aligned tensors):
//   * K13 _attn_kernel (_forward_call), launcher hpfg_attn_sm90_fwd: per
//     (window, head) o = (softmax(q k^T * D^-1/2 + bias[h] + mask[w]) *
//     dropout mask) v;
//   * K14 _attn_bwd_kernel (_backward_call), launcher hpfg_attn_sm90_bwd:
//     the softmax recomputed, then dq, dk, dv and dbias = the sum over
//     windows of ds, summed inside the kernel (no column-sum launch).
// window_attention.cu's mma.sync kernels (the mma route) keep fp32, the
// head widths this file does not take and the static rules of attn_route.
//
// What bounds them on an H100: per (window, head) at L = 49, D = 32 each
// product is 2 L^2 D = 154 KFLOP on 9.4 KB of bf16 q, k, v: about 50 FLOPs
// a byte against the 295 the tensor cores need, so the bound is bytes: q,
// k, v (and do) read once, o (or dq, dk, dv) written once (chip_smoke.py
// attn_work). What sets the pace is keeping enough of those bytes in
// flight, and the fp32 work per score element between the products
// (scale, bias, exp, the hash dropout, dS), which at small L was mostly
// spent on padding.
//
// The design:
//   * the walk: the windows of one head and one shift-mask class, w = r +
//     n_mask * b (r the class), are packed G = floor(64 / L) to a 64-row
//     tile (7 at L = 9, 4 at L = 16, 1 at L = 49), a tile's slot g holding
//     window b0 + g of its class; a head's tiles are numbered class-major
//     and a CTA of the grid (ctas, H) takes a run of tiles_per_cta of them
//     (ops/window_attention.py packed_walk);
//   * TMA in: a 4-D tensor map over the packed qkv [Bn, L, 3C] as [3C, L,
//     n_mask, Bn / n_mask] (and one over do [Bn, L, C]) takes one head's
//     q, k or v of a whole tile in one box [D, L, 1, G]: G * L rows of D
//     channels, laid out with the swizzle of the row's 2D bytes, so the
//     tile is at once wgmma's K-major operand (q, k; do, v for dP) and its
//     MN-major one (v for P v, k for dS k, q and do for the transposed
//     products). Past the class's last window TMA fills zeros; rows past
//     G * L are zeroed once per CTA and never written;
//   * one producer warp keeps a ring of two tiles in flight, one full and
//     one empty mbarrier a stage, so the next tile loads while the consumer
//     warpgroup computes one; the work per tile is short (the fp32 work of
//     a 64-row tile on four warps), so what hides its latencies is CTAs an
//     SM: four of K13 and three of K14 at D <= 32 (registers capped by
//     __launch_bounds__, the bias term in shared memory rather than in 28
//     registers, K14's staged outputs in the room of P o M and dS);
//   * the consumer warpgroup (four warps, warp w the tile's rows 16w ..
//     16w + 15, so a score row lives in one warp's registers): S = q k^T
//     by wgmma m64nNk16 from shared memory, N = 56 where G * L <= 56 (L =
//     49), else 64; the softmax and the dropout in fp32 in registers; K13
//     then O = P v with P from registers as the A operand (two bf16 terms,
//     p_hi and p_lo) and v MN-major from shared memory; K14 dP = do v^T
//     likewise, dS in registers, then P o M and dS staged once as bf16
//     [64][64] tiles (128-byte swizzle): dQ = dS k reads dS as its K-major
//     A operand, dV = (P o M)^T do and dK = dS^T q read P o M and dS as
//     their MN-major one: no cross-warp sum. Each sum's first k16 step
//     takes scale-d 0 in place of zeroed accumulators: zeroing them
//     before the wgmmas made ptxas serialize every K14 wgmma (C7520);
//   * packing: scores between two windows of a tile are -inf before the
//     max (bias[h] + mask[r] is the same L x L block repeated down the
//     diagonal, -inf off it), so the softmax is block-diagonal and P, dS
//     are exactly 0 there; a thread keeps its score fragments' bias +
//     mask (or -inf) in shared memory for its run of one class;
//   * no work on padding: the fp32 work (scale, bias, exp, the hash, dS,
//     the dbias sums) runs only on the n8 column blocks that hold a live
//     key of the warp's rows (at L = 9 three of eight; PACK, the
//     instantiation for G > 1: with one window a tile every block holds
//     live keys, and that code tests none); inside a block every element
//     takes the same instructions, with no branch of its own, so the
//     independent elements' exp and hash chains interleave;
//   * TMA out: o (or dq, dk, dv) is rounded to bf16 into a swizzled staging
//     tile and written by one TMA store of the tile's box, which clips the
//     windows past the class's last;
//   * K14's dbias: each thread adds its live fp32 dS to the CTA's [G][L][L]
//     sums in shared memory (each element has one owner thread, so the
//     order is the CTA's tile order); at the end the CTA adds its slots in
//     slot order into one partial row [L * L]; the CTA that takes the last
//     ticket of its group of DB_GROUP CTAs adds the group's rows in row
//     order, and the last group's closer adds the group rows in order into
//     dbias: bitwise the same from run to run, and no column-sum launch.
//
// Semantics are those of window_attention.cu: s = q k^T * scale + (bias +
// mask) as one fp32 term; p = exp(s - max) times one correctly rounded
// reciprocal a row; K13 feeds P o M to P v as p_hi = bf16(p) and p_lo =
// bf16(p - p_hi); K14 rounds P o M and dS to bf16 once and sums dbias from
// the fp32 dS; dq = (ds k) * scale, dk = (ds^T q) * scale. The dropout hash
// (hash.cuh) keys on b_idx = (w / blk) * 1024 + h and row (w % blk) * L +
// i, w the window's index in the global batch (through the image-id map
// under data parallelism): never on the tile, the CTA or the slot.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hash.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int AT_ROWS = 64;              // rows of a tile: a warpgroup's M
constexpr int AT_CONS = 128;             // the consumer warpgroup
constexpr int AT_NT = AT_CONS + 32;      // and the producer warp
constexpr int FWD_ST = 2;                // ring stages, K13
constexpr int BWD_ST = 2;                // K14
constexpr int DB_GROUP = 8;              // partial rows a group's closer sums
constexpr int PT_BYTES = AT_ROWS * 64 * 2;  // a [64][64] bf16 P o M or dS tile
constexpr int HEAD_BYTES = 1024;         // mbarriers and the ticket flag

struct AttnDrop {
  int on;
  uint32_t seed;
  uint32_t thresh;
  float scale;
};

struct AttnArgs {
  const float* bias;   // [H, L, L]
  const float* mask;   // [n_mask, L, L] or null
  const int* ids;      // [Bn / nw] each image's index in the global batch
  float* part;         // K14: [H, ctas, llp] each CTA's dbias row
  float* grp;          // K14: [H, ng, llp] each group's sum
  float* dbias;        // K14: [H, L, L]
  unsigned* tickets;   // K14: [H, ng + 1], zero between launches
  int L, H, n_mask, per, G, tpc, T, tpx, ng, nw, blk, llp;
  float scale;
  AttnDrop drop;
};

struct AttnMaps {
  CUtensorMap qkv;  // loads: [3C, L, n_mask, per], box [D, L, 1, G]
  CUtensorMap d;    // K14: do [C, L, n_mask, per]
  CUtensorMap o;    // stores: K13's o [C, ...], K14's dqkv [3C, ...]
};

template <int D>
struct AttnTile {
  static constexpr int SW = 2 * D;               // row bytes = swizzle
  static constexpr int BYTES = AT_ROWS * SW;     // a staged tile
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Byte offset of byte b of row r in a tile of SW-byte rows, as TMA's
// SW-byte swizzle lays it out from a 1024-byte aligned base (the 16-byte
// chunk index XOR address bits 7 and up).
template <int SW>
__device__ __forceinline__ uint32_t swz(int r, int b) {
  return (uint32_t)(r * SW + ((((b >> 4) ^ ((r * SW >> 7) & (SW / 16 - 1))))
                              << 4) + (b & 15));
}

// tile tau of a head: class r, first window index b0 in the class, live
// slots (windows b0 .. b0 + live - 1 of the class)
struct TileOf {
  int r, b0, live;
};
__device__ __forceinline__ TileOf tile_of(const AttnArgs& a, int tau) {
  const int r = tau / a.tpc;
  const int b0 = (tau - r * a.tpc) * a.G;
  return TileOf{r, b0, min(a.G, a.per - b0)};
}

// The window the hash keys on: w itself, or its index in the global
// batch's windows through the image-id map
__device__ __forceinline__ int global_win(const AttnArgs& a, int w) {
  return a.ids != nullptr ? a.ids[w / a.nw] * a.nw + w % a.nw : w;
}

// The consumer thread's place in the tile: rows 16 warp + lane / 4 + 8 hf
// (hf = 0, 1), their slots and in-window rows, and the warp's n8 column
// blocks [jlo, jhi) that hold a live key of its rows.
struct Frag {
  int lane, warp, row[2], slot[2], i[2], jlo, jhi;
  __device__ Frag(int tid, int L, int G, int NK) {
    lane = tid & 31;
    warp = tid >> 5;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      row[hf] = 16 * warp + (lane >> 2) + 8 * hf;
      slot[hf] = row[hf] / L;
      i[hf] = row[hf] - slot[hf] * L;
    }
    const int r0 = 16 * warp;
    if (r0 >= G * L) {
      jlo = jhi = 0;
    } else {
      const int g0 = r0 / L, g1 = min(G - 1, (r0 + 15) / L);
      jlo = g0 * L / 8;
      jhi = min(NK / 8, ((g1 + 1) * L + 7) / 8);
    }
  }
  __device__ int col(int j, int e) const { return 8 * j + 2 * (lane & 3) + e; }
  __device__ bool blk(int j) const { return j >= jlo && j < jhi; }
};

// bias[h] + mask[r] at the thread's score fragments (element x = 4j + 2hf
// + e: row row[hf], column col(j, e)) of the packed tile: the block of
// slot g on the diagonal, -inf off it; 0 in a row past G * L (never
// stored). Kept in shared memory, element x of consumer thread t at
// bm[x * AT_CONS + t] (each thread reads only its own: no barrier);
// returns the bits of the elements that are not -inf.
template <int NK>
__device__ __forceinline__ uint32_t load_bm(float* bm, const AttnArgs& a,
                                            const Frag& f, int h, int r) {
  const int L = a.L;
  const float* bias_h = a.bias + (size_t)h * L * L;
  const float* mask_r = a.mask ? a.mask + (size_t)r * L * L : nullptr;
  uint32_t live = 0;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = f.col(j, e), gk = c / L, x = 4 * j + 2 * hf + e;
        float v = 0.f;
        if (f.slot[hf] < a.G) {
          if (gk != f.slot[hf]) {
            v = -INFINITY;
          } else {
            const int o = f.i[hf] * L + (c - gk * L);
            v = __ldg(bias_h + o);
            if (mask_r) v += __ldg(mask_r + o);
          }
        }
        bm[x * AT_CONS] = v;
        if (v != -INFINITY) live |= 1u << x;
      }
  return live;
}

// Scores -> fp32 probabilities in place on the warp's live column blocks
// (every block unless PACK; 0 elsewhere): s * scale + bm, row max and sum
// over the row's blocks and the quad's four lanes, p = e * (1 / sum): one
// IEEE division a row.
template <int NK, bool PACK>
__device__ __forceinline__ void softmax_frag(float (&s)[NK / 2],
                                             const float* bm, const Frag& f,
                                             float scale) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * hf + e;
        if (!PACK || f.blk(j)) {
          s[x] = s[x] * scale + bm[x * AT_CONS];
          m = fmaxf(m, s[x]);
        }
      }
    m = fmaxf(m, __shfl_xor_sync(~0u, m, 1));
    m = fmaxf(m, __shfl_xor_sync(~0u, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * hf + e;
        if (!PACK || f.blk(j)) {
          s[x] = expf(s[x] - m);
          sum += s[x];
        } else {
          s[x] = 0.f;
        }
      }
    sum += __shfl_xor_sync(~0u, sum, 1);
    sum += __shfl_xor_sync(~0u, sum, 2);
    const float inv = 1.f / sum;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!PACK || f.blk(j)) s[4 * j + 2 * hf + e] *= inv;
  }
}

// The dropout keys of the thread's two rows in tile t: b_idx and the
// hash row of the window in their slot; live[hf]: the slot holds a window
struct RowKeys {
  int b_idx[2], hrow[2];
  bool live[2];
  __device__ RowKeys(const AttnArgs& a, const Frag& f, const TileOf& t,
                     int h) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      live[hf] = f.slot[hf] < t.live;
      b_idx[hf] = hrow[hf] = 0;
      if (live[hf] && a.drop.on) {
        const int wg = global_win(a, t.r + a.n_mask * (t.b0 + f.slot[hf]));
        b_idx[hf] = (wg / a.blk) * 1024 + h;
        hrow[hf] = (wg % a.blk) * a.L + f.i[hf];
      }
    }
  }
  __device__ float operator()(const AttnArgs& a, const Frag& f, int hf,
                              int c) const {
    return hash_keep(a.drop.seed, a.drop.thresh, a.drop.scale, b_idx[hf],
                     hrow[hf], a.L, c - f.slot[hf] * a.L);
  }
};

// The fp32 fragments of the tile's 64 columns (NK of them held) as the
// bf16 A fragments of the four k16 steps over them, two terms: hi rounded
// once and lo the rounding error c - hi rounded (hi + lo keeps about 16
// bits)
template <int NK>
__device__ __forceinline__ void to_a(uint32_t (&hi)[4][4],
                                     uint32_t (&lo)[4][4],
                                     const float (&c)[NK / 2]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 2 * kk + (q >> 1), hf = q & 1;
      const float v0 = j < NK / 8 ? c[4 * j + 2 * hf] : 0.f;
      const float v1 = j < NK / 8 ? c[4 * j + 2 * hf + 1] : 0.f;
      hi[kk][q] = pack_bf16(v0, v1);
      lo[kk][q] = pack_bf16(v0 - bf2f(hi[kk][q] & 0xffffu),
                            v1 - bf2f(hi[kk][q] >> 16));
    }
}

// acc (64 x D) of the thread's rows, times mul, rounded to bf16 into a
// staging tile of the store map's swizzle; rows past rows_live skipped
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* dst,
                                           const float (&acc)[D / 2],
                                           const Frag& f, int rows_live,
                                           float mul) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (f.row[hf] >= rows_live) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(
          dst + swz<2 * D>(f.row[hf], 2 * f.col(j, 0))) =
          pack_bf16(acc[4 * j + 2 * hf] * mul, acc[4 * j + 2 * hf + 1] * mul);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int x = 0; x < R; ++x) d[x] = 0.f;
}

// Zero rows [G L, 64) of the n staged tiles from base (TMA never writes
// them), and the extra bytes [extra0, extra1) of shared memory, in 16-byte
// pieces by all AT_NT threads.
template <int D>
__device__ __forceinline__ void zero_pads(uint8_t* smem, uint8_t* tiles,
                                          int n, int rows_live,
                                          uint32_t extra0, uint32_t extra1) {
  constexpr int SW = AttnTile<D>::SW;
  const int pad = (AT_ROWS - rows_live) * SW / 16;
  for (int x = threadIdx.x; x < n * pad; x += AT_NT) {
    const int t = x / pad, p = x - t * pad;
    *reinterpret_cast<uint4*>(tiles + t * AttnTile<D>::BYTES +
                              rows_live * SW + 16 * p) = make_uint4(0, 0, 0, 0);
  }
  for (uint32_t o = extra0 + 16 * threadIdx.x; o < extra1; o += 16 * AT_NT)
    *reinterpret_cast<uint4*>(smem + o) = make_uint4(0, 0, 0, 0);
}

// K13 and K14 share the launch: grid (ctas, H), AT_NT threads, CTA x of
// head h the tiles [x tpx, min((x + 1) tpx, T)). Shared memory: the
// mbarriers, the ring of staged tiles, then K13's staging tile or K14's P
// o M and dS tiles (where dq, dk, dv are staged once wgmma has read them),
// the bias term (load_bm), and K14's dbias sums [G][L][L] fp32 (sized at
// launch).
template <int D, int NK, bool BWD>
struct AttnSmem {
  static constexpr int TILE = AttnTile<D>::BYTES;
  static constexpr int ST = BWD ? BWD_ST : FWD_ST;
  static constexpr int NLOAD = BWD ? 4 : 3;        // q, k, v (, do)
  static constexpr int RING = HEAD_BYTES;
  static constexpr int OUT = RING + ST * NLOAD * TILE;
  static constexpr int OUT_BYTES =
      BWD ? (2 * PT_BYTES > 3 * TILE ? 2 * PT_BYTES : 3 * TILE) : TILE;
  static constexpr int BM = OUT + OUT_BYTES;
  static constexpr int SDB = BM + NK / 2 * AT_CONS * 4;
  // the dynamic size: the sums' bytes, and the base's alignment
  static int smem(int sdb_bytes) { return SDB + sdb_bytes + 1024; }
};

// The dynamic shared memory from a 1024-byte aligned base (TMA's swizzle
// and wgmma's descriptors assume it).
__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ uint8_t smem_raw[];
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// The mbarriers (full[ST] then empty[ST]), initialised by thread 0: full
// completes on its stage's TMA bytes, empty on one arrival from each of
// the four consumer warps.
template <int ST>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The producer warp's loop (its lane 0): tile n of the CTA into stage n %
// ST once the consumers have released the stage's previous tile; q, k, v
// from the qkv map, and with do_map do.
template <int D, int ST, int NLOAD>
__device__ __forceinline__ void produce(const AttnMaps& maps,
                                        const AttnArgs& a, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int t0, int nt, int h) {
  constexpr int TILE = AttnTile<D>::BYTES;
  const int C = a.H * D;
  for (int n = 0; n < nt; ++n) {
    const int st = n % ST;
    if (n >= ST) mbar_wait(&empty[st], ((n / ST) - 1) & 1);
    const TileOf t = tile_of(a, t0 + n);
    mbar_expect_tx(&full[st], NLOAD * D * a.L * a.G * 2);
    const uint32_t dst = smem_u32(ring + st * NLOAD * TILE);
    for (int u = 0; u < 3; ++u)
      tma_4d(dst + u * TILE, &maps.qkv, &full[st], u * C + h * D, 0, t.r,
             t.b0);
    if (NLOAD == 4)
      tma_4d(dst + 3 * TILE, &maps.d, &full[st], h * D, 0, t.r, t.b0);
  }
}

// K13. PACK: G > 1 windows a tile, whose warps skip their dead column
// blocks (with one window a tile every block holds live keys)
template <int D, int NK, bool PACK>
__global__ void __launch_bounds__(AT_NT, D <= 32 ? 4 : 2)
    attn_fwd_sm90_kernel(const __grid_constant__ AttnMaps maps,
                         const AttnArgs a) {
  using S = AttnSmem<D, NK, false>;
  constexpr int SW = AttnTile<D>::SW, TILE = S::TILE;
  uint8_t* smem = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S::ST;
  uint8_t* ring = smem + S::RING;
  uint8_t* stage = smem + S::OUT;
  const int tid = threadIdx.x, h = blockIdx.y, L = a.L;
  float* bm = reinterpret_cast<float*>(smem + S::BM) + tid;
  const int t0 = blockIdx.x * a.tpx, nt = min(a.tpx, a.T - t0);
  const int rows_live = a.G * L;

  init_ring<S::ST>(full, empty);
  zero_pads<D>(smem, ring, S::ST * S::NLOAD, rows_live, 0, 0);
  fence_proxy_async();
  __syncthreads();
  if (tid >= AT_CONS) {  // the producer warp
    if (tid == AT_CONS)
      produce<D, S::ST, S::NLOAD>(maps, a, ring, full, empty, t0, nt, h);
    return;
  }

  const Frag f(tid, L, a.G, NK);
  int cur_r = -1;
  for (int n = 0; n < nt; ++n) {
    const int st = n % S::ST;
    const TileOf t = tile_of(a, t0 + n);
    if (t.r != cur_r) {
      load_bm<NK>(bm, a, f, h, t.r);
      cur_r = t.r;
    }
    const RowKeys keys(a, f, t, h);
    mbar_wait(&full[st], (n / S::ST) & 1);
    const uint32_t sq = smem_u32(ring + st * S::NLOAD * TILE);
    const uint32_t sk = sq + TILE, sv = sq + 2 * TILE;

    float s[NK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<NK, 0, 0>(s, desc_k(sq + 32 * kk, SW), desc_k(sk + 32 * kk, SW),
                         kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    softmax_frag<NK, PACK>(s, bm, f, a.scale);
    if (a.drop.on) {
      // every element of the live blocks, with no branch of its own, so
      // the hashes interleave: P is 0 at a dead one, and the rows of a slot
      // without a window are never stored
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        if (PACK && !f.blk(j)) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s[4 * j + 2 * hf + e] *= keys(a, f, hf, f.col(j, e));
      }
    }
    // P as p_hi + p_lo: rounding P to bf16 alone took the SwinUNet's eval
    // argmax agreement below chip_smoke.py's 99% gate
    uint32_t ph[4][4], pl[4][4];
    to_a<NK>(ph, pl, s);
    float o[D / 2];
    zero(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mn(sv + kk * 16 * SW, 0, SW);
      wgmma_rs<D>(o, ph[kk], dv);
      wgmma_rs<D>(o, pl[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    if (f.lane == 0) mbar_arrive(&empty[st]);  // the stage is read

    if (tid == 0) bulk_wait_read();  // the last store has read the staging
    consumer_sync();
    stage_rows<D>(stage, o, f, rows_live, 1.f);
    fence_proxy_async();
    consumer_sync();
    if (tid == 0) {
      tma_store_4d(&maps.o, smem_u32(stage), h * D, 0, t.r, t.b0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

// dst[c] = the sum of rows 0 .. nrows - 1 of src (stride4 float4 apart),
// in row order, for c < n4 float4 columns, eight rows' loads in flight
__device__ __forceinline__ void sum_rows(float4* dst, const float4* src,
                                         int nrows, size_t stride4, int n4) {
  for (int c = threadIdx.x; c < n4; c += AT_CONS) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < nrows; r0 += 8) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (r0 + i < nrows) v[i] = __ldcg(src + (r0 + i) * stride4 + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (r0 + i < nrows) {
          acc.x += v[i].x;
          acc.y += v[i].y;
          acc.z += v[i].z;
          acc.w += v[i].w;
        }
    }
    dst[c] = acc;
  }
}

// The last CTA of a group sums the group's partial rows, the last group's
// closer the group rows, each in row order: dbias[h] (see the header).
// Its [L * L] floats go through sum_rows' float4 columns in the CTA's
// shared memory (the ring, free by then).
__device__ __forceinline__ void dbias_tickets(const AttnArgs& a, int h,
                                              int* s_flag, float4* scratch) {
  const int tid = threadIdx.x, x = blockIdx.x, P = gridDim.x;
  const int g = x / DB_GROUP, gsize = min(DB_GROUP, P - g * DB_GROUP);
  const int q4 = a.llp / 4;
  unsigned* tk = a.tickets + (size_t)h * (a.ng + 1);
  __threadfence();
  consumer_sync();
  if (tid == 0) *s_flag = atomicAdd(&tk[1 + g], 1u) == (unsigned)gsize - 1;
  consumer_sync();
  if (!*s_flag) return;
  __threadfence();
  sum_rows(reinterpret_cast<float4*>(a.grp + ((size_t)h * a.ng + g) * a.llp),
           reinterpret_cast<const float4*>(
               a.part + ((size_t)h * P + g * DB_GROUP) * a.llp),
           gsize, q4, q4);
  __threadfence();
  consumer_sync();
  if (tid == 0) {
    tk[1 + g] = 0u;
    *s_flag = atomicAdd(&tk[0], 1u) == (unsigned)a.ng - 1;
  }
  consumer_sync();
  if (!*s_flag) return;
  __threadfence();
  sum_rows(scratch, reinterpret_cast<const float4*>(
                        a.grp + (size_t)h * a.ng * a.llp),
           a.ng, q4, q4);
  consumer_sync();
  const int LL = a.L * a.L;
  const float* sums = reinterpret_cast<const float*>(scratch);
  for (int c = tid; c < LL; c += AT_CONS) a.dbias[(size_t)h * LL + c] = sums[c];
  if (tid == 0) tk[0] = 0u;
}

// K14, PACK as K13's
template <int D, int NK, bool PACK>
__global__ void __launch_bounds__(AT_NT, D <= 32 ? 3 : 1)
    attn_bwd_sm90_kernel(const __grid_constant__ AttnMaps maps,
                         const AttnArgs a) {
  using S = AttnSmem<D, NK, true>;
  constexpr int SW = AttnTile<D>::SW, TILE = S::TILE;
  uint8_t* smem = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S::ST;
  int* s_flag = reinterpret_cast<int*>(smem + 512);
  uint8_t* ring = smem + S::RING;
  uint8_t* s_pm = smem + S::OUT;  // then the staged dq, dk, dv
  uint8_t* s_ds = s_pm + PT_BYTES;
  const int tid = threadIdx.x, h = blockIdx.y, L = a.L, C = a.H * D;
  float* bm = reinterpret_cast<float*>(smem + S::BM) + tid;
  float* sdb = reinterpret_cast<float*>(smem + S::SDB);  // [G][L][L]
  const int t0 = blockIdx.x * a.tpx, nt = min(a.tpx, a.T - t0);
  const int rows_live = a.G * L;

  init_ring<S::ST>(full, empty);
  // the dbias sums start at zero (and P o M's columns past NK, which
  // only reach output rows past G * L)
  zero_pads<D>(smem, ring, S::ST * S::NLOAD, rows_live, S::OUT,
               S::SDB + (rows_live * L * 4 + 15) / 16 * 16);
  fence_proxy_async();
  __syncthreads();
  if (tid >= AT_CONS) {  // the producer warp
    if (tid == AT_CONS)
      produce<D, S::ST, S::NLOAD>(maps, a, ring, full, empty, t0, nt, h);
    return;
  }

  const Frag f(tid, L, a.G, NK);
  uint32_t live = 0;
  int cur_r = -1;
  for (int n = 0; n < nt; ++n) {
    const int st = n % S::ST;
    const TileOf t = tile_of(a, t0 + n);
    if (t.r != cur_r) {
      live = load_bm<NK>(bm, a, f, h, t.r);
      cur_r = t.r;
    }
    const RowKeys keys(a, f, t, h);
    mbar_wait(&full[st], (n / S::ST) & 1);
    const uint32_t sq = smem_u32(ring + st * S::NLOAD * TILE);
    const uint32_t sk = sq + TILE, sv = sq + 2 * TILE, sdo = sq + 3 * TILE;
    // the last tile's stores have read the staged dq, dk, dv, whose room
    // P o M and dS take
    if (tid == 0) bulk_wait_read();
    consumer_sync();

    float p[NK / 2], dp[NK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<NK, 0, 0>(p, desc_k(sq + 32 * kk, SW), desc_k(sk + 32 * kk, SW),
                         kk > 0);
      wgmma_ss<NK, 0, 0>(dp, desc_k(sdo + 32 * kk, SW),
                         desc_k(sv + 32 * kk, SW), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(p);
    fence_acc(dp);
    softmax_frag<NK, PACK>(p, bm, f, a.scale);
    // on the live blocks: P = 0 in a row without a window; dP o M; P o M
    // to shared memory (bf16); r = sum_j dP P per row. Elsewhere dP and
    // P o M are 0 (the room held the last tile's staged outputs). The
    // mask multiplies every element of a live block (P is 0 at a dead
    // one), with no branch of its own, so the hashes interleave.
    const float pz[2] = {keys.live[0] ? 1.f : 0.f, keys.live[1] ? 1.f : 0.f};
    float rs[2] = {0.f, 0.f};
    auto pm_pass = [&](auto drop_c) {
      constexpr bool DROP = decltype(drop_c)::value;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int x = 4 * j + 2 * hf;
          uint32_t* pm_at = reinterpret_cast<uint32_t*>(
              s_pm + swz<128>(f.row[hf], 2 * f.col(j, 0)));
          if (PACK && !f.blk(j)) {
            dp[x] = dp[x + 1] = 0.f;
            *pm_at = 0u;
            continue;
          }
          float pm[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[x + e] *= pz[hf];
            const float m = DROP ? keys(a, f, hf, f.col(j, e)) : 1.f;
            dp[x + e] *= m;
            pm[e] = p[x + e] * m;
            rs[hf] += dp[x + e] * p[x + e];
          }
          *pm_at = pack_bf16(pm[0], pm[1]);
        }
    };
    if (a.drop.on)
      pm_pass(std::true_type{});
    else
      pm_pass(std::false_type{});
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rs[hf] += __shfl_xor_sync(~0u, rs[hf], 1);
      rs[hf] += __shfl_xor_sync(~0u, rs[hf], 2);
    }
    // dS = P (dP - r) in place of dP: into the dbias sums (fp32; element
    // (slot, i, j) of the live ones) and shared memory (bf16)
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int x = 4 * j + 2 * hf;
        uint32_t* ds_at = reinterpret_cast<uint32_t*>(
            s_ds + swz<128>(f.row[hf], 2 * f.col(j, 0)));
        if (PACK && !f.blk(j)) {
          *ds_at = 0u;
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[x + e] = p[x + e] * (dp[x + e] - rs[hf]);
          if (keys.live[hf] && (live >> (x + e) & 1))
            sdb[f.row[hf] * L + f.col(j, e) - f.slot[hf] * L] += dp[x + e];
        }
        *ds_at = pack_bf16(dp[x], dp[x + 1]);
      }
    // P o M and dS complete and visible to wgmma
    fence_proxy_async();
    consumer_sync();
    float dq[D / 2], dv[D / 2], dk[D / 2];
    wgmma_fence();
    const uint32_t pm0 = smem_u32(s_pm), ds0 = smem_u32(s_ds);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // dQ = dS k with dS K-major from shared memory
      wgmma_ss<D, 0, 1>(dq, desc_k(ds0 + 32 * kk, 128),
                        desc_mn(sk + kk * 16 * SW, 0, SW), kk > 0);
      wgmma_ss<D, 1, 1>(dv, desc_mn(pm0 + kk * 16 * 128, 0, 128),
                        desc_mn(sdo + kk * 16 * SW, 0, SW), kk > 0);
      wgmma_ss<D, 1, 1>(dk, desc_mn(ds0 + kk * 16 * 128, 0, 128),
                        desc_mn(sq + kk * 16 * SW, 0, SW), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
    fence_acc(dv);
    fence_acc(dk);
    if (f.lane == 0) mbar_arrive(&empty[st]);  // the stage is read
    consumer_sync();  // every warp's wgmmas have read P o M and dS

    stage_rows<D>(s_pm, dq, f, rows_live, a.scale);
    stage_rows<D>(s_pm + TILE, dk, f, rows_live, a.scale);
    stage_rows<D>(s_pm + 2 * TILE, dv, f, rows_live, 1.f);
    fence_proxy_async();
    consumer_sync();
    if (tid == 0) {
      for (int u = 0; u < 3; ++u)
        tma_store_4d(&maps.o, smem_u32(s_pm + u * TILE), u * C + h * D, 0,
                     t.r, t.b0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();

  // the CTA's partial row: its sums over the slots, in slot order
  consumer_sync();
  const int LL = L * L;
  float* prow = a.part + ((size_t)h * gridDim.x + blockIdx.x) * a.llp;
  for (int c = tid; c < LL; c += AT_CONS) {
    float acc = 0.f;
    for (int g = 0; g < a.G; ++g) acc += sdb[g * LL + c];
    prow[c] = acc;
  }
  dbias_tickets(a, h, s_flag, reinterpret_cast<float4*>(ring));
}

template <int D, int NK, bool PACK>
int launch_fwd(const AttnMaps& maps, const AttnArgs& a, int ctas,
               cudaStream_t stream) {
  using S = AttnSmem<D, NK, false>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_sm90_kernel<D, NK, PACK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem(0));
  (void)attr;  // a refusal shows as the launch's error
  attn_fwd_sm90_kernel<D, NK, PACK>
      <<<dim3(ctas, a.H), AT_NT, S::smem(0), stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int D, int NK, bool PACK>
int launch_bwd(const AttnMaps& maps, const AttnArgs& a, int ctas,
               cudaStream_t stream) {
  using S = AttnSmem<D, NK, true>;
  const int smem = S::smem((a.G * a.L * a.L * 4 + 15) / 16 * 16);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_sm90_kernel<D, NK, PACK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem(AT_ROWS * 64 * 4));
  (void)attr;
  attn_bwd_sm90_kernel<D, NK, PACK>
      <<<dim3(ctas, a.H), AT_NT, smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

// The instantiation of head width D, NK key columns and PACK (G > 1)
template <bool BWD>
int launch_d(int D, int nk, const AttnMaps& maps, const AttnArgs& a,
             int ctas, cudaStream_t s) {
  auto pick = [&](auto d) {
    constexpr int DD = decltype(d)::value;
    const bool pack = a.G > 1;
    if (BWD) {
      if (nk == 56)
        return pack ? launch_bwd<DD, 56, true>(maps, a, ctas, s)
                    : launch_bwd<DD, 56, false>(maps, a, ctas, s);
      return pack ? launch_bwd<DD, 64, true>(maps, a, ctas, s)
                  : launch_bwd<DD, 64, false>(maps, a, ctas, s);
    }
    if (nk == 56)
      return pack ? launch_fwd<DD, 56, true>(maps, a, ctas, s)
                  : launch_fwd<DD, 56, false>(maps, a, ctas, s);
    return pack ? launch_fwd<DD, 64, true>(maps, a, ctas, s)
                : launch_fwd<DD, 64, false>(maps, a, ctas, s);
  };
  switch (D) {
    case 16: return pick(std::integral_constant<int, 16>{});
    case 32: return pick(std::integral_constant<int, 32>{});
    case 64: return pick(std::integral_constant<int, 64>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The arguments both launchers share; an error where the call is outside
// the route (attn_route) or the grid does not cover the tiles once.
int make_args(AttnArgs* a, const void* bias, const void* mask, int n_mask,
              int Bn, int L, int H, int D, float scale, int drop_on,
              unsigned seed, unsigned thresh, float drop_scale,
              const void* ids, int nw, int blk, int G, int tpx, int ctas) {
  if ((D != 16 && D != 32 && D != 64) || L < 1 || G < 1 ||
      G * L > AT_ROWS || n_mask < 1 || Bn % n_mask || tpx < 1 ||
      (ids != nullptr && (nw < 1 || Bn % nw)))
    return (int)cudaErrorInvalidValue;
  *a = AttnArgs{};
  a->bias = static_cast<const float*>(bias);
  a->mask = static_cast<const float*>(mask);
  a->ids = static_cast<const int*>(ids);
  a->L = L;
  a->H = H;
  a->n_mask = n_mask;
  a->per = Bn / n_mask;
  a->G = G;
  a->tpc = (a->per + G - 1) / G;
  a->T = n_mask * a->tpc;
  a->tpx = tpx;
  a->ng = (ctas + DB_GROUP - 1) / DB_GROUP;
  a->nw = nw;
  a->blk = blk;
  a->llp = (L * L + 3) / 4 * 4;
  a->scale = scale;
  a->drop = AttnDrop{drop_on, seed, thresh, drop_scale};
  if ((ctas - 1) * tpx >= a->T || ctas * tpx < a->T)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// A token-major tensor [Bn, L, width] of the class-major window walk:
// [width, L, n_mask, Bn / n_mask], boxes of one head's D channels over the
// L tokens of G windows of one class
int encode_windows(CUtensorMap* map, const void* t, int width, int L,
                   int n_mask, int per, int D, int G) {
  const uint64_t d[4] = {(uint64_t)width, (uint64_t)L, (uint64_t)n_mask,
                         (uint64_t)per};
  const uint32_t box[4] = {(uint32_t)D, (uint32_t)L, 1, (uint32_t)G};
  return encode(map, t, 4, d, box);
}

int key_cols(int G, int L) { return G * L <= 56 ? 56 : 64; }

}  // namespace

extern "C" {

// K13 on wgmma: qkv [Bn, L, 3*H*D] and out [Bn, L, H*D] bf16 (16-byte
// aligned), bias [H, L, L] fp32, mask [n_mask, L, L] fp32 or null (n_mask
// 1); the dropout and ids (int32 [Bn / nw] or null) as
// hpfg_window_attention_fwd's; G windows a tile, a CTA of the grid (ctas,
// H) walks tiles_per_cta tiles (ops/window_attention.py packed_walk).
int hpfg_attn_sm90_fwd(const void* qkv, const void* bias, const void* mask,
                       int n_mask, void* out, int Bn, int L, int H, int D,
                       float scale, int drop_on, unsigned seed,
                       unsigned thresh, float drop_scale, const void* ids,
                       int nw, int blk, int G, int tiles_per_cta, int ctas,
                       void* stream) {
  AttnArgs a;
  int err = make_args(&a, bias, mask, n_mask, Bn, L, H, D, scale, drop_on,
                      seed, thresh, drop_scale, ids, nw, blk, G,
                      tiles_per_cta, ctas);
  AttnMaps maps;
  if (!err)
    err = encode_windows(&maps.qkv, qkv, 3 * H * D, L, n_mask, a.per, D, G);
  if (!err)
    err = encode_windows(&maps.o, out, H * D, L, n_mask, a.per, D, G);
  if (err) return err;
  maps.d = maps.qkv;  // unread
  return launch_d<false>(D, key_cols(G, L), maps, a, ctas,
                         static_cast<cudaStream_t>(stream));
}

// K14 on wgmma: as K13, plus dout [Bn, L, H*D] and dqkv [Bn, L, 3*H*D]
// bf16; part [H, ctas, llp] and grp [H, ceil(ctas / 8), llp] fp32
// scratch (llp = L*L rounded up to 4), dbias [H, L, L] fp32 written whole,
// tickets [H * (ceil(ctas / 8) + 1)] uint32 zeroed (the kernel leaves them
// zeroed).
int hpfg_attn_sm90_bwd(const void* qkv, const void* bias, const void* mask,
                       int n_mask, const void* dout, void* dqkv, void* part,
                       void* grp, void* dbias, void* tickets, int Bn, int L,
                       int H, int D, float scale, int drop_on, unsigned seed,
                       unsigned thresh, float drop_scale, const void* ids,
                       int nw, int blk, int G, int tiles_per_cta, int ctas,
                       void* stream) {
  AttnArgs a;
  int err = make_args(&a, bias, mask, n_mask, Bn, L, H, D, scale, drop_on,
                      seed, thresh, drop_scale, ids, nw, blk, G,
                      tiles_per_cta, ctas);
  a.part = static_cast<float*>(part);
  a.grp = static_cast<float*>(grp);
  a.dbias = static_cast<float*>(dbias);
  a.tickets = static_cast<unsigned*>(tickets);
  AttnMaps maps;
  if (!err)
    err = encode_windows(&maps.qkv, qkv, 3 * H * D, L, n_mask, a.per, D, G);
  if (!err)
    err = encode_windows(&maps.d, dout, H * D, L, n_mask, a.per, D, G);
  if (!err)
    err = encode_windows(&maps.o, dqkv, 3 * H * D, L, n_mask, a.per, D, G);
  if (err) return err;
  return launch_d<true>(D, key_cols(G, L), maps, a, ctas,
                        static_cast<cudaStream_t>(stream));
}

// The dbias groups' size (K14's DB_GROUP), for the wrapper's buffers
int hpfg_attn_sm90_dbias_group() { return DB_GROUP; }

}  // extern "C"
