// Hand-written BatchNorm-affine + LeakyReLU kernels for the UNet ConvBlock on
// Hopper: kernel C (forward) and kernel D (train-mode backward).
//
// Replaces (hpfg_tpu/ops/pallas/conv_block.py):
//   * bn_act_kernel, launcher hpfg_bn_act: kernel C, _bn_act_kernel (K3,
//     body :810, pallas_call :957): y = lrelu(a*g + b), stored in g's type;
//   * bn_coop_kernel, launcher hpfg_bn_coop: the full D (and D's reduce
//     alone) on the vector path, K4 and K5 in one cooperative launch
//     (below);
//   * bn_reduce_kernel, launcher hpfg_bn_reduce: D's reduce on the element
//     path, _bwd_reduce_kernel (K4, body :1151, pallas_call :1274): per channel
//     S0 = sum dz and S1 = sum dz*xhat, dz = dy*lrelu'(a*pre + b),
//     xhat = (pre - mean)*inv, the cross-CTA sum finished inside the kernel;
//   * bn_dpre_kernel, launcher hpfg_bn_dpre: D's elementwise pass,
//     _dpre_kernel (K5, body :1166, pallas_call :1288):
//     dpre = a*(dz - S0/N - xhat*S1/N), in dy's type; alone it is
//     bn_act_dpre, after K11 reduced the sums in its epilogue.
//
// What bounds them on an H100: bytes. Each pass moves 2 (C), 4 (D's reduce)
// or 6 (dpre) bytes of bf16 per element of the NHWC activation [P, F] for a
// handful of FLOPs, so HBM's 3.35 TB/s is the roofline; the per-channel
// vectors are fp32 [F]. At the small stages (14^2, 28^2 at batch 32: 3-6 MB
// a tensor) a call lasts a few microseconds, and latency and the tail count
// as much as the stream.
//
// What the design does about it:
//   * one walk for all three kernels: a thread owns one fixed group of V
//     contiguous channels (V = 8 in bf16, 4 in fp32: 16 bytes), and a CTA
//     of 256 threads covers 256/G rows of G = F/V groups a step. A turn is
//     U = 4 consecutive steps; a thread issues its U 16-byte loads of each
//     input before it uses the first, and its first turn's loads before it
//     reads its per-channel vectors (16-byte loads, then registers for the
//     CTA's life). No element needs a % F. The walk's sizes come from the
//     host (ops/bn_act.py bn_walk), so no 64-bit division stands before a
//     thread's first load. F above 256 groups splits over grid.y. Stores
//     are 16 bytes;
//   * C and dpre launch one CTA per turn, so a CTA streams 4 KB-16 KB of
//     consecutive rows and exits; D's reduce takes a persistent grid (its
//     resident CTAs, from the occupancy API, and at most about
//     sqrt(P*es/4) of them: ops/bn_act.py bn_walk), since each of its CTAs
//     writes a partial row that the last CTA reads back;
//   * where F % V != 0 or a pointer is not 16-byte aligned, the same walk
//     runs with V = 1 (the element path);
//   * D's reduce finishes its own sums: a CTA sums its threads' fp32
//     [S0, S1] through shared memory in a fixed tree, writes one partial
//     row, fences and takes a ticket from a per-device counter; the CTA
//     that arrives last sums every partial row in a fixed order (16-byte
//     loads, 16 in flight a thread), writes sums [2, F] and resets the
//     counter for the next call on the stream. No float atomics: the sums
//     are bitwise the same from run to run, and a full backward on the
//     element path is two launches (reduce, dpre);
//   * dy and pre are read twice by such a backward (5 passes against the
//     bound's 3): dpre walks the rows from the last, so it first reads what
//     the reduce read last, while that is still in the 50 MB L2. L2
//     eviction-priority hints (evict_last on the rows dpre reads first,
//     demoted after dpre's read) were slower and are not used (PERF.md);
//   * rounding as the plain version (ops/bn_act.py *_reference): z = a*pre
//     + b rounds as a multiply then an add (__fmul_rn / __fadd_rn: nvcc
//     would contract it to an FMA), so the z >= 0 branch of lrelu' agrees
//     element for element; slope 0.01f; S/N as S * (1/N), as PyTorch's CUDA
//     division by a scalar computes it; round-to-nearest-even stores. C is
//     bitwise equal to its plain version on the card, and so is dpre from
//     given sums.
//
// D's cooperative form (bn_coop_kernel, launcher hpfg_bn_coop): a full
// backward in ONE launch, the reduce and the dpre of K4 and K5 with the
// cross-CTA sum between them, on a grid that fills the card. ops/bn_act.py
// (bn_route, coop_plan) sends bf16 and fp32 calls on the vector path
// (F % V == 0, 16-byte aligned pointers) here; the element path keeps
// bn_reduce_kernel and bn_dpre_kernel, as does bn_act_dpre after K11:
//   * the grid: every SM, one or two CTAs each, from the occupancy API at
//     the chosen dynamic shared memory, launched with
//     cudaLaunchCooperativeKernel, which refuses a grid that cannot be
//     co-resident rather than hanging at a barrier. The rows go in chunks
//     of CR rows (at most 8 KB of each tensor, sized so the chunks split
//     evenly over the grid), CTA i taking chunks i, i + grid, ...: the
//     grid reads one moving window of dy and of pre, not 2 x grid streams
//     far apart;
//   * phase 1, the reduce: one thread copies each chunk of dy and of pre
//     into a shared-memory stage by bulk copies (cp.async.bulk, expect-tx
//     on the stage's mbarrier), so a CTA has up to its whole ring in
//     flight; a thread owns one channel group of V channels and rows rr,
//     rr + R, ... of each chunk (R = 256 / G), and sums dz and dz*xhat in
//     fp32 in bn_reduce_kernel's z, dz and xhat order; the CTA's threads
//     then fold rows in a fixed tree into one partial row;
//   * a grid barrier (a per-device counter: each CTA adds one and waits
//     for the grid's count, acquire loads; it is the epoch of the
//     launch, and the last CTA to leave resets it to 0 for the next
//     launch on the stream), then phase 2, the finish in parallel: the
//     2F columns in 16-byte units, unit u to warp u of the grid's warps
//     (u, u + 8 grid, ...); a lane sums rows lane, lane + 32, ... in
//     order, a fixed shuffle tree adds the lanes, lane 0 writes sums. No
//     single CTA reads every partial row, and the sums are bitwise the
//     same from run to run;
//   * a second grid barrier, then phase 3, dpre: each thread reads its
//     channels' sums (bypassing L1) and writes dpre for its rows. The
//     hold form keeps every chunk of the CTA's range in its own stage
//     (at 14^2, 28^2 and 56^2 at batch 32 dy and pre fit the resident
//     CTAs' shared memory), so dpre reads them from there: three HBM
//     passes, the bound. The stream form passes a CTA's chunks through a
//     ring of four stages but keeps its last chunks in as many held
//     stages as fit beside the ring; dpre takes the held chunks from
//     shared memory and reads the others again in reverse chunk order,
//     first what phase 1 read last (still in L2), as bn_dpre_kernel
//     does. ops/bn_act.py coop_plan picks the form from the bytes and
//     the occupancy API, never at run time;
//   * bn_reduce alone (a data-parallel rank) is phases 1 and 2 in the
//     stream form: one barrier;
//   * numerics as the two-launch D: z = a*pre + b as a multiply then an
//     add, S/N as S * (1/N); dpre is bitwise equal to the plain version
//     from the kernel's own sums.
//
// One counter per device for each of D's forms: two backward reduces must
// not run at once on different streams of one device (the port runs one
// stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int NT = 256;  // threads a CTA
constexpr float SLOPE = 0.01f;

// V elements of one thread's access: 16 bytes on the vector path, one
// element on the element path.
template <bool BF16, bool VEC>
struct Pack {
  static constexpr int N = VEC ? (BF16 ? 8 : 4) : 1;
  using Raw = std::conditional_t<VEC, uint4,
                                 std::conditional_t<BF16, uint16_t, float>>;

  static __device__ __forceinline__ void unpack(const Raw& r, float (&x)[N]) {
    if constexpr (VEC) {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (BF16) {
          x[2 * i] = __uint_as_float(w[i] << 16);
          x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        } else {
          x[i] = __uint_as_float(w[i]);
        }
      }
    } else if constexpr (BF16) {
      x[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
    } else {
      x[0] = r;
    }
  }

  static __device__ __forceinline__ uint32_t bf(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }

  static __device__ __forceinline__ Raw pack(const float (&x)[N]) {
    if constexpr (VEC) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (BF16)
          w[i] = bf(x[2 * i]) | (bf(x[2 * i + 1]) << 16);
        else
          w[i] = __float_as_uint(x[i]);
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (BF16) {
      return static_cast<uint16_t>(bf(x[0]));
    } else {
      return x[0];
    }
  }
};

// The steps of a turn: a thread issues the loads of U steps before it uses
// the first (ops/bn_act.py TURN_STEPS).
constexpr int U = 4;

// The walk's sizes, computed on the host (ops/bn_act.py bn_walk): P rows of
// F channels, cols channel groups a CTA, R rows a step, steps = ceil(P/R).
struct WalkArgs {
  long long P, steps;
  int F, cols, R;
};

// The walk shared by the three kernels: G = F/V channel groups; a CTA
// covers cols of them (group chunk blockIdx.y) and R rows a step; thread t
// owns row t / cols of each step and group blockIdx.y*cols + t % cols; turn
// k is the U consecutive steps kU .. kU+U-1, and CTA x walks turns x, x +
// gridDim.x, ... (C and dpre launch one CTA per turn, the reduce a
// persistent grid). The sizes come from the host: a thread's first loads
// wait on no 64-bit division (PERF.md, tune run 7).
template <int N>
struct Walk {
  WalkArgs a;
  int G, rr, c;
  bool active;

  __device__ Walk(const WalkArgs& w) : a(w) {
    G = a.F / N;
    rr = threadIdx.x / a.cols;
    c = blockIdx.y * a.cols + threadIdx.x % a.cols;
    active = rr < a.R && c < G;
  }

  // the CTA's next turn after turn k; false past the last step
  __device__ __forceinline__ bool next(long long& k) const {
    k += gridDim.x;
    return k * U < a.steps;
  }

  // offsets (in accesses) and validity of the U steps of turn k (the CTA's
  // first is blockIdx.x); ``reverse`` walks the rows from the last step
  __device__ __forceinline__ void turn(long long k, bool reverse,
                                       long long (&off)[U],
                                       bool (&ok)[U]) const {
    const long long s0 = k * U;
    const long long row0 = (reverse ? a.steps - 1 - s0 : s0) * a.R + rr;
    const long long off0 = row0 * G + c;
    const int d = a.R * G;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = reverse ? row0 - u * a.R : row0 + u * a.R;
      ok[u] = active && s0 + u < a.steps && row < a.P;
      off[u] = reverse ? off0 - u * d : off0 + u * d;
    }
  }
};

// N per-channel values from v[ch..ch+N): 16-byte loads on the vector path
// (the wrapper checks the alignment), else one element
template <int N, bool VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ v, int ch,
                                         float (&x)[N]) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(v + ch + j);
      x[j] = q.x;
      x[j + 1] = q.y;
      x[j + 2] = q.z;
      x[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = v[ch + j];
  }
}

// kernel C: y = lrelu(a*g + b)
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(NT)
    bn_act_kernel(const void* __restrict__ g_, const float* __restrict__ a_,
                  const float* __restrict__ b_, void* __restrict__ y_,
                  WalkArgs wa) {
  using PK = Pack<BF16, VEC>;
  using Raw = typename PK::Raw;
  constexpr int N = PK::N;
  const Walk<N> w(wa);
  const int ch = w.c * N;
  const Raw* g = static_cast<const Raw*>(g_);
  Raw* y = static_cast<Raw*>(y_);
  Raw in[U];
  long long off[U];
  bool ok[U];
  long long k = blockIdx.x;
  // the first turn's loads go out before the per-channel vectors
  w.turn(k, false, off, ok);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u]) in[u] = g[off[u]];
  float a[N], b[N];
  if (w.active) {
    load_vec<N, VEC>(a_, ch, a);
    load_vec<N, VEC>(b_, ch, b);
  }
  while (true) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float x[N];
      PK::unpack(in[u], x);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float z = __fadd_rn(__fmul_rn(x[j], a[j]), b[j]);
        x[j] = z >= 0.f ? z : __fmul_rn(z, SLOPE);
      }
      y[off[u]] = PK::pack(x);
    }
    if (!w.next(k)) break;
    w.turn(k, false, off, ok);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ok[u]) in[u] = g[off[u]];
  }
}

// D's reduce: per-CTA [S0, S1] partials, the last CTA sums them.
// part: [gridDim.x, PW] fp32 (PW = 2F rounded up to 4: S0 then S1 then
// padding); sums: [2, F] fp32; counter: a zeroed unsigned.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(NT)
    bn_reduce_kernel(const void* __restrict__ dy_, const void* __restrict__ pre_,
                     const float* __restrict__ a_, const float* __restrict__ b_,
                     const float* __restrict__ m_,
                     const float* __restrict__ inv_, float* __restrict__ part,
                     float* __restrict__ sums, unsigned* __restrict__ counter,
                     WalkArgs wa, int PW) {
  using PK = Pack<BF16, VEC>;
  using Raw = typename PK::Raw;
  constexpr int N = PK::N;
  const Walk<N> w(wa);
  const int F = wa.F;
  const int ch = w.c * N;
  const Raw* dy = static_cast<const Raw*>(dy_);
  const Raw* pre = static_cast<const Raw*>(pre_);
  Raw in_dy[U], in_pre[U];
  long long off[U];
  bool ok[U];
  auto fetch = [&]() {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      in_dy[u] = dy[off[u]];
      in_pre[u] = pre[off[u]];
    }
  };
  long long k = blockIdx.x;
  w.turn(k, false, off, ok);
  fetch();
  float a[N], b[N], m[N], inv[N], s0[N], s1[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s0[j] = s1[j] = 0.f;
  if (w.active) {
    load_vec<N, VEC>(a_, ch, a);
    load_vec<N, VEC>(b_, ch, b);
    load_vec<N, VEC>(m_, ch, m);
    load_vec<N, VEC>(inv_, ch, inv);
  }
  while (true) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float d[N], p[N];
      PK::unpack(in_dy[u], d);
      PK::unpack(in_pre[u], p);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float z = __fadd_rn(__fmul_rn(p[j], a[j]), b[j]);
        const float dz = z >= 0.f ? d[j] : __fmul_rn(d[j], SLOPE);
        const float xhat = __fmul_rn(__fsub_rn(p[j], m[j]), inv[j]);
        s0[j] += dz;
        s1[j] += dz * xhat;
      }
    }
    if (!w.next(k)) break;
    w.turn(k, false, off, ok);
    fetch();
  }

  // the CTA's partial: rows rr of one group summed in a fixed tree
  __shared__ float red[2 * N][NT];
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    red[j][t] = s0[j];
    red[N + j][t] = s1[j];
  }
  __syncthreads();
  int h = 1;
  while (h < wa.R) h <<= 1;
  for (h >>= 1; h >= 1; h >>= 1) {
    if (w.rr < h && w.rr + h < wa.R) {
#pragma unroll
      for (int j = 0; j < 2 * N; ++j) red[j][t] += red[j][t + h * wa.cols];
    }
    __syncthreads();
  }
  float* row = part + (size_t)blockIdx.x * PW;
  if (w.rr == 0 && w.active) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      row[ch + j] = red[j][t];
      row[F + ch + j] = red[N + j][t];
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (t == 0)
    last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA: sums over the partial rows, each column in row order in
  // Q interleaved slices (slice q takes rows q, q + Q, ...), the slices
  // then added in order; 16-byte loads that bypass L1, 16 in flight
  constexpr int L = 16;
  const int rows = gridDim.x, WQ = PW / 4;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  const int Q = WQ >= NT ? 1 : NT / WQ;
  __shared__ float4 fin[NT];
  for (int j0 = 0; j0 < WQ; j0 += NT) {
    const int q = t / WQ < Q ? t / WQ : Q;  // Q: idle
    const int j = Q == 1 ? j0 + t : t % WQ;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < Q && j < WQ) {
      int r = q;
      for (; r + (L - 1) * Q < rows; r += L * Q) {
        float4 v[L];
#pragma unroll
        for (int i = 0; i < L; ++i)
          v[i] = __ldcg(p4 + (size_t)(r + i * Q) * WQ + j);
#pragma unroll
        for (int i = 0; i < L; ++i) {
          acc.x += v[i].x;
          acc.y += v[i].y;
          acc.z += v[i].z;
          acc.w += v[i].w;
        }
      }
      for (; r < rows; r += Q) {
        const float4 v = __ldcg(p4 + (size_t)r * WQ + j);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    fin[t] = acc;
    __syncthreads();
    if (q == 0 && j < WQ) {
      for (int i = 1; i < Q; ++i) {
        const float4 v = fin[i * WQ + j];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      const float o[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * j + e < 2 * F) sums[4 * j + e] = o[e];
    }
    __syncthreads();
  }
  if (t == 0) *counter = 0u;
}

// D's elementwise pass: dpre = a*(dz - S0/N - xhat*S1/N), walking the
// steps from the last, so it first reads what the reduce read last.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(NT)
    bn_dpre_kernel(const void* __restrict__ dy_, const void* __restrict__ pre_,
                   const float* __restrict__ a_, const float* __restrict__ b_,
                   const float* __restrict__ m_, const float* __restrict__ inv_,
                   const float* __restrict__ sums, void* __restrict__ out_,
                   WalkArgs wa) {
  using PK = Pack<BF16, VEC>;
  using Raw = typename PK::Raw;
  constexpr int N = PK::N;
  const Walk<N> w(wa);
  const int F = wa.F;
  const int ch = w.c * N;
  const Raw* dy = static_cast<const Raw*>(dy_);
  const Raw* pre = static_cast<const Raw*>(pre_);
  Raw* out = static_cast<Raw*>(out_);
  Raw in_dy[U], in_pre[U];
  long long off[U];
  bool ok[U];
  auto fetch = [&]() {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      in_dy[u] = dy[off[u]];
      in_pre[u] = pre[off[u]];
    }
  };
  long long k = blockIdx.x;
  w.turn(k, true, off, ok);
  fetch();
  float a[N], b[N], m[N], inv[N], u0[N], u1[N];
  if (w.active) {
    const float inv_n = __fdiv_rn(1.f, static_cast<float>(wa.P));
    load_vec<N, VEC>(a_, ch, a);
    load_vec<N, VEC>(b_, ch, b);
    load_vec<N, VEC>(m_, ch, m);
    load_vec<N, VEC>(inv_, ch, inv);
    load_vec<N, VEC>(sums, ch, u0);
    load_vec<N, VEC>(sums + F, ch, u1);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      u0[j] = __fmul_rn(u0[j], inv_n);
      u1[j] = __fmul_rn(u1[j], inv_n);
    }
  }
  while (true) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float d[N], p[N];
      PK::unpack(in_dy[u], d);
      PK::unpack(in_pre[u], p);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float z = __fadd_rn(__fmul_rn(p[j], a[j]), b[j]);
        const float dz = z >= 0.f ? d[j] : __fmul_rn(d[j], SLOPE);
        const float xhat = __fmul_rn(__fsub_rn(p[j], m[j]), inv[j]);
        d[j] = __fmul_rn(a[j], __fsub_rn(__fsub_rn(dz, u0[j]),
                                         __fmul_rn(xhat, u1[j])));
      }
      out[off[u]] = PK::pack(d);
    }
    if (!w.next(k)) break;
    w.turn(k, true, off, ok);
    fetch();
  }
}

// -- D's cooperative form -----------------------------------------------

constexpr int COOP_MAX_STAGES = 32;  // mbarriers: the hold form's chunks
constexpr int COOP_WARPS = NT / 32;
// static shared memory of bn_coop_kernel (the bf16 tree, the barriers):
// the dynamic ring may take the rest of an SM's 227 KB
constexpr int COOP_STATIC = 2 * 8 * NT * 4 + COOP_MAX_STAGES * 8;
constexpr int COOP_MAX_DYNAMIC = 232448 - COOP_STATIC;

struct CoopArgs {
  const void* dy;
  const void* pre;
  const float* a;
  const float* b;
  const float* m;
  const float* inv;
  float* part;        // [gridDim.x][2F]: the CTAs' partial rows
  float* sums;        // [2F]: [S0, S1]
  void* out;          // dpre [P, F], or null: the reduce alone
  unsigned* counter;  // the grid barrier's, 0 between launches
  long long P;
  // CR rows a chunk; S ring stages (0 in the hold form) and H held
  // stages after them: a CTA's last H chunks land in the held stages and
  // stay, the others pass through the ring
  int F, chunk_rows, stages, held;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every CTA of the (co-resident) grid arrives, then waits until the count
// reaches target: the k-th barrier of a launch waits for k * grid.
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (ld_acquire(counter) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

template <bool BF16>
__global__ void __launch_bounds__(NT) bn_coop_kernel(const CoopArgs ca) {
  using PK = Pack<BF16, true>;
  using Raw = typename PK::Raw;  // 16 bytes
  constexpr int N = PK::N;
  constexpr int ES = BF16 ? 2 : 4;
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t bar[COOP_MAX_STAGES];
  __shared__ float red[2 * N][NT];
  const int tid = threadIdx.x;
  const int F = ca.F, G = F / N, R = NT / G;
  const int rr = tid / G, c = tid % G, ch = c * N;
  const bool active = rr < R;
  const unsigned grid = gridDim.x;
  // the rows in chunks of CR; this CTA's chunk k is the grid's chunk
  // blockIdx.x + k * grid, so the grid reads one moving window of rows
  const int CR = ca.chunk_rows, S = ca.stages, H = ca.held;
  const long long chunks = (ca.P + CR - 1) / CR;
  const int nck = (int)((chunks - blockIdx.x + grid - 1) / grid);
  const int nr = max(0, nck - H);  // chunks through the ring: the first
  const int row_bytes = F * ES;
  const int half = CR * row_bytes;  // dy's part of a stage, then pre's
  const uint8_t* dy = static_cast<const uint8_t*>(ca.dy);
  const uint8_t* pre = static_cast<const uint8_t*>(ca.pre);

  if (tid == 0) {
    for (int s = 0; s < S + H; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto row_of = [&](int k) {
    return ((long long)blockIdx.x + (long long)k * grid) * CR;
  };
  auto chunk_n = [&](int k) { return (int)min((long long)CR, ca.P - row_of(k)); };
  // chunk k's stage: the ring's k % S, or held stage S + (k - nr)
  auto stage_of = [&](int k) { return k < nr ? k % S : S + (k - nr); };
  auto issue = [&](int k, int s) {
    const uint32_t bytes = (uint32_t)(chunk_n(k) * row_bytes);
    const size_t off = (size_t)row_of(k) * row_bytes;
    uint8_t* d = ring + (size_t)s * 2 * half;
    mbar_expect_tx(&bar[s], 2 * bytes);
    bulk_g2s(d, dy + off, bytes, &bar[s]);
    bulk_g2s(d + half, pre + off, bytes, &bar[s]);
  };
  if (tid == 0) {
    for (int k = 0; k < min(S, nr); ++k) issue(k, k);
    for (int k = nr; k < nck; ++k) issue(k, stage_of(k));
  }

  float a[N], b[N], m[N], inv[N], s0[N], s1[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s0[j] = s1[j] = 0.f;
  if (active) {
    load_vec<N, true>(ca.a, ch, a);
    load_vec<N, true>(ca.b, ch, b);
    load_vec<N, true>(ca.m, ch, m);
    load_vec<N, true>(ca.inv, ch, inv);
  }

  // phase 1: the reduce over the CTA's chunks, in order
  for (int k = 0; k < nck; ++k) {
    const int s = stage_of(k);
    mbar_wait(&bar[s], k < nr ? (k / S) & 1 : 0);
    const uint8_t* d = ring + (size_t)s * 2 * half;
    const int n = chunk_n(k);
    if (active) {
#pragma unroll 4
      for (int r = rr; r < n; r += R) {
        float dv[N], pv[N];
        PK::unpack(*reinterpret_cast<const Raw*>(d + r * row_bytes + c * 16),
                   dv);
        PK::unpack(*reinterpret_cast<const Raw*>(d + half + r * row_bytes +
                                                 c * 16),
                   pv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float z = __fadd_rn(__fmul_rn(pv[j], a[j]), b[j]);
          const float dz = z >= 0.f ? dv[j] : __fmul_rn(dv[j], SLOPE);
          const float xhat = __fmul_rn(__fsub_rn(pv[j], m[j]), inv[j]);
          s0[j] += dz;
          s1[j] += dz * xhat;
        }
      }
    }
    if (k + S < nr) {  // the ring's stage takes its next chunk
      __syncthreads();
      if (tid == 0) issue(k + S, s);
    }
  }

  // the CTA's partial row: rows rr of one group summed in a fixed tree
#pragma unroll
  for (int j = 0; j < N; ++j) {
    red[j][tid] = s0[j];
    red[N + j][tid] = s1[j];
  }
  __syncthreads();
  int h = 1;
  while (h < R) h <<= 1;
  for (h >>= 1; h >= 1; h >>= 1) {
    if (rr < h && rr + h < R) {
#pragma unroll
      for (int j = 0; j < 2 * N; ++j) red[j][tid] += red[j][tid + h * G];
    }
    __syncthreads();
  }
  float* prow = ca.part + (size_t)blockIdx.x * 2 * F;
  if (rr == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      prow[ch + j] = red[j][tid];
      prow[F + ch + j] = red[N + j][tid];
    }
  }
  grid_barrier(ca.counter, grid);

  // phase 2: unit u (4 columns of 2F) to warp u of the grid's warps; a
  // lane sums rows lane, lane + 32, ... in order, a fixed shuffle tree
  // adds the lanes
  {
    const int lane = tid & 31, wid = tid >> 5, units = 2 * F / 4;
    const float4* p4 = reinterpret_cast<const float4*>(ca.part);
    for (int u = blockIdx.x * COOP_WARPS + wid; u < units;
         u += grid * COOP_WARPS) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int r = lane; r < (int)grid; r += 32) {
        const float4 v = __ldcg(p4 + (size_t)r * units + u);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
      }
      if (lane == 0) reinterpret_cast<float4*>(ca.sums)[u] = acc;
    }
  }
  const unsigned barriers = ca.out != nullptr ? 2u : 1u;
  if (ca.out != nullptr) {
    grid_barrier(ca.counter, 2 * grid);

    // phase 3: dpre from the grid's sums
    float u0[N], u1[N];
    if (active) {
      const float inv_n = __fdiv_rn(1.f, static_cast<float>(ca.P));
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        const float4 q0 = __ldcg(reinterpret_cast<const float4*>(
            ca.sums + ch + j));
        const float4 q1 = __ldcg(reinterpret_cast<const float4*>(
            ca.sums + F + ch + j));
        u0[j] = q0.x;
        u0[j + 1] = q0.y;
        u0[j + 2] = q0.z;
        u0[j + 3] = q0.w;
        u1[j] = q1.x;
        u1[j + 1] = q1.y;
        u1[j + 2] = q1.z;
        u1[j + 3] = q1.w;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        u0[j] = __fmul_rn(u0[j], inv_n);
        u1[j] = __fmul_rn(u1[j], inv_n);
      }
    }
    Raw* out = static_cast<Raw*>(ca.out);
    auto dpre_chunk = [&](int k, int s) {
      const uint8_t* d = ring + (size_t)s * 2 * half;
      const int n = chunk_n(k);
      const long long row0 = row_of(k);
      if (!active) return;
#pragma unroll 4
      for (int r = rr; r < n; r += R) {
        float dv[N], pv[N];
        PK::unpack(*reinterpret_cast<const Raw*>(d + r * row_bytes + c * 16),
                   dv);
        PK::unpack(*reinterpret_cast<const Raw*>(d + half + r * row_bytes +
                                                 c * 16),
                   pv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float z = __fadd_rn(__fmul_rn(pv[j], a[j]), b[j]);
          const float dz = z >= 0.f ? dv[j] : __fmul_rn(dv[j], SLOPE);
          const float xhat = __fmul_rn(__fsub_rn(pv[j], m[j]), inv[j]);
          dv[j] = __fmul_rn(a[j], __fsub_rn(__fsub_rn(dz, u0[j]),
                                            __fmul_rn(xhat, u1[j])));
        }
        out[(row0 + r) * G + c] = PK::pack(dv);
      }
    };
    // the ring's chunks again, last first (what phase 1 read last, still
    // in L2), their loads issued before the held chunks' dpre; a ring
    // stage's phase goes on from its fills of phase 1
    auto fills = [&](int s) { return s < nr ? (nr - 1 - s) / S + 1 : 0; };
    if (tid == 0)
      for (int q = 0; q < min(S, nr); ++q) issue(nr - 1 - q, q);
    for (int k = nr; k < nck; ++k) dpre_chunk(k, stage_of(k));
    for (int q = 0; q < nr; ++q) {
      const int s = q % S;
      mbar_wait(&bar[s], (fills(s) + q / S) & 1);
      dpre_chunk(nr - 1 - q, s);
      if (q + S < nr) {
        __syncthreads();
        if (tid == 0) issue(nr - 1 - (q + S), s);
      }
    }
  }
  // the last CTA to leave resets the counter for the next launch
  __syncthreads();
  if (tid == 0 && atomicAdd(ca.counter, 1u) == (barriers + 1) * grid - 1)
    atomicExch(ca.counter, 0u);
}

template <bool BF16>
cudaError_t coop_attr() {
  static const cudaError_t e = cudaFuncSetAttribute(
      bn_coop_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      COOP_MAX_DYNAMIC);
  return e;
}

template <bool BF16>
int coop_occupancy(int smem) {
  cudaError_t e = coop_attr<BF16>();
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bn_coop_kernel<BF16>, NT, smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <bool BF16>
int reduce_occupancy() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, bn_reduce_kernel<BF16, true>, NT, 0);
  return e == cudaSuccess ? n : -(int)e;
}

#define BN_DISPATCH(KERNEL, ...)                                  \
  do {                                                            \
    if (is_bf16 && vec)                                           \
      KERNEL<true, true><<<grid, NT, 0, s>>>(__VA_ARGS__);        \
    else if (is_bf16)                                             \
      KERNEL<true, false><<<grid, NT, 0, s>>>(__VA_ARGS__);       \
    else if (vec)                                                 \
      KERNEL<false, true><<<grid, NT, 0, s>>>(__VA_ARGS__);       \
    else                                                          \
      KERNEL<false, false><<<grid, NT, 0, s>>>(__VA_ARGS__);      \
  } while (0)

// The host's walk (ops/bn_act.py bn_walk), or false where it does not fit
// a CTA of NT threads or its chunks miss channel groups.
bool walk_args(long long P, int F, int is_bf16, int vec, int cols, int R,
               int chunks, WalkArgs& w) {
  const int G = F / (vec ? (is_bf16 ? 8 : 4) : 1);
  if (cols < 1 || R < 1 || cols * R > NT || (long long)cols * chunks < G)
    return false;
  w = WalkArgs{P, (P + R - 1) / R, F, cols, R};
  return true;
}

}  // namespace

extern "C" {

// CTAs of 256 threads an SM can hold of D's reduce (vector path) in bf16
// or fp32: its persistent grid; a negative value is a CUDA error.
int hpfg_bn_reduce_ctas_per_sm(int is_bf16) {
  return is_bf16 ? reduce_occupancy<true>() : reduce_occupancy<false>();
}

// CTAs of 256 threads an SM can hold of D's cooperative kernel in bf16 or
// fp32 with smem bytes of dynamic shared memory; a negative value is a
// CUDA error.
int hpfg_bn_coop_ctas_per_sm(int is_bf16, int smem) {
  return is_bf16 ? coop_occupancy<true>(smem) : coop_occupancy<false>(smem);
}

// D's cooperative kernel: dy, pre, out [P, F] (bf16 when is_bf16, else
// fp32; out null: the reduce alone); a, b, mean, inv [F] fp32; part
// [ctas, 2F] fp32 scratch; sums [2F] fp32 out; counter: this device's
// zeroed unsigned (the kernel leaves it zeroed). The plan of
// ops/bn_act.py coop_plan: chunk_rows rows a chunk, stages ring stages
// and held stages of 2 * chunk_rows * F elements each (the hold form: no
// ring, a held stage per chunk of the longest range), ctas CTAs
// (co-resident), smem dynamic bytes. Every pointer 16-byte aligned, F a
// multiple of 16 bytes' elements, F / V <= 256.
int hpfg_bn_coop(const void* dy, const void* pre, const void* a,
                 const void* b, const void* mean, const void* inv, void* part,
                 void* sums, void* out, void* counter, long long P, int F,
                 int chunk_rows, int stages, int held, int is_bf16, int ctas,
                 int smem, void* stream) {
  const int v = is_bf16 ? 8 : 4;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(pre) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(mean) |
                         reinterpret_cast<uintptr_t>(inv) |
                         reinterpret_cast<uintptr_t>(sums) |
                         reinterpret_cast<uintptr_t>(part);
  const long long chunks = (P + chunk_rows - 1) / (chunk_rows > 0 ? chunk_rows : 1);
  const long long longest = (chunks + ctas - 1) / (ctas > 0 ? ctas : 1);
  if (F % v || F / v > NT || F < v || ctas < 1 || chunk_rows < 1 ||
      stages < 0 || held < 0 || stages + held > COOP_MAX_STAGES ||
      (ptrs & 15) ||
      smem < 2LL * (stages + held) * chunk_rows * F * (is_bf16 ? 2 : 4) ||
      smem > COOP_MAX_DYNAMIC ||
      (stages == 0 && held < longest))
    return (int)cudaErrorInvalidValue;
  CoopArgs ca{dy,
              pre,
              static_cast<const float*>(a),
              static_cast<const float*>(b),
              static_cast<const float*>(mean),
              static_cast<const float*>(inv),
              static_cast<float*>(part),
              static_cast<float*>(sums),
              out,
              static_cast<unsigned*>(counter),
              P,
              F,
              chunk_rows,
              stages,
              held};
  void* args[] = {&ca};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? coop_attr<true>() : coop_attr<false>();
  if (e != cudaSuccess) return (int)e;
  e = is_bf16 ? cudaLaunchCooperativeKernel(
                    reinterpret_cast<void*>(bn_coop_kernel<true>), ctas, NT,
                    args, smem, s)
              : cudaLaunchCooperativeKernel(
                    reinterpret_cast<void*>(bn_coop_kernel<false>), ctas, NT,
                    args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// g, y [P, F] (bf16 when is_bf16, else fp32); a, b [F] fp32; vec: 16-byte
// path (F % V == 0, every pointer 16-byte aligned); the walk: cols groups a
// CTA, R rows a step, grid (ctas, chunks).
int hpfg_bn_act(const void* g, const void* a, const void* b, void* y,
                long long P, int F, int cols, int R, int is_bf16, int vec,
                int ctas, int chunks, void* stream) {
  WalkArgs w;
  if (!walk_args(P, F, is_bf16, vec, cols, R, chunks, w))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ctas, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(bn_act_kernel, g, static_cast<const float*>(a),
              static_cast<const float*>(b), y, w);
  return (int)cudaGetLastError();
}

// dy, pre [P, F]; a, b, mean, inv [F] fp32; part [ctas, PW] fp32 scratch;
// sums [2, F] fp32 out; counter: this device's zeroed unsigned.
int hpfg_bn_reduce(const void* dy, const void* pre, const void* a,
                   const void* b, const void* mean, const void* inv,
                   void* part, void* sums, void* counter, long long P, int F,
                   int cols, int R, int is_bf16, int vec, int ctas,
                   int chunks, int PW, void* stream) {
  WalkArgs w;
  if (!walk_args(P, F, is_bf16, vec, cols, R, chunks, w))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ctas, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(bn_reduce_kernel, dy, pre, static_cast<const float*>(a),
              static_cast<const float*>(b), static_cast<const float*>(mean),
              static_cast<const float*>(inv), static_cast<float*>(part),
              static_cast<float*>(sums), static_cast<unsigned*>(counter), w,
              PW);
  return (int)cudaGetLastError();
}

// dy, pre, out [P, F]; a, b, mean, inv [F] and sums [2, F] fp32.
int hpfg_bn_dpre(const void* dy, const void* pre, const void* a,
                 const void* b, const void* mean, const void* inv,
                 const void* sums, void* out, long long P, int F, int cols,
                 int R, int is_bf16, int vec, int ctas, int chunks,
                 void* stream) {
  WalkArgs w;
  if (!walk_args(P, F, is_bf16, vec, cols, R, chunks, w))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ctas, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(bn_dpre_kernel, dy, pre, static_cast<const float*>(a),
              static_cast<const float*>(b), static_cast<const float*>(mean),
              static_cast<const float*>(inv),
              static_cast<const float*>(sums), out, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
