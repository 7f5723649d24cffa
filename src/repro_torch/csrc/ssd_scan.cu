// Mamba2 SSD chunked scan for Hopper (sm_90a) [arXiv:2405.21060], from a
// zero state, returning y only; float32 or bfloat16 x/B/C.  Built for p 64
// and n 64 or 128; the wrapper zero-pads a narrower x, B or C to them
// (padded columns add exact zeros to every sum) and slices y back.  Any
// wider p or n runs in blocks (kernels/ssd_scan.py `ssd_blocked`): p in
// blocks of 64 columns as heads of their own (y's p columns and the
// state's p rows never mix), n in blocks of up to 128 columns, one call a
// block, whose y's the wrapper sums (y is linear in the n-blocks of B and
// C).  A bf16 call of a block of such a sum writes a float32 y (dtype 2,
// the YF32 instances), so the sum rounds to bf16 once.  A wider N
// instance was not taken: two heads' state splits alone would take 192 KB
// of the 227 KB a block may have at N 256.
//
// Replaces the TPU Pallas kernel src/repro/kernels/ssd_scan.py:_ssd_kernel
// (launcher `ssd_scan`, its pallas_call).  That kernel walks (batch, head,
// chunk) with the chunk axis sequential and keeps the (P, N) float32 state
// in VMEM scratch.  On the TPU the sequential grid is free; on the card a
// block per (batch, head) walking every chunk leaves most SMs idle.  So
// the chunk axis is split into groups of GROUP chunks, in three launches:
//
//   1. ssd_kernel_state_*, grid (G - 1, heads, b): each group but the last
//      runs its chunks from a zero state, keeping only what the state
//      update needs; it writes the group's end state (N x P f32) and its
//      decay (the product of exp(cA_last) over its chunks) to scratch;
//   2. ssd_kernel_pass, grid (N P / 256, h, b): walks the groups in order
//      and overwrites each slot with the group's incoming state;
//   3. ssd_kernel_scan_*, grid (G, heads, b): each group scans its chunks
//      from its incoming state (the whole per-chunk body below).
//
// Launch 2 leaves the float32 incoming state of every group in `states`;
// when autograd needs the gradient the wrapper keeps that buffer for the
// backward (csrc/ssd_scan_bwd.cu) instead of dropping it: the launches are
// the same either way.
//
// A scan of one group (s <= GROUP * L) is launch 3 alone.  GROUP = 8:
// at the prefill shape (64 chunks) that makes 8 groups and 16.8 MB of
// group states, which stay in the 50 MB L2; per-chunk states would be 134
// MB of f32 traffic.  A single-pass decoupled look-back was not taken: it
// needs no redundant state product, but it chains 64 waits per sequence
// and spins on flags.
//
// Per chunk of L = 64 rows, all with float32 accuracy (as _ssd_kernel):
//   dA = dt * A, cA = inclusive cumsum(dA)            (a warp scan)
//   W[i][j] = (C_i . B_j) * exp(cA_i - cA_j) for i >= j, else 0
//   y_i = sum_j W[i][j] (dt_j x_j) + (C_i . state) * exp(cA_i)
//   state <- state * exp(cA_last) + sum_j (B_j exp(cA_last - cA_j)) x_j dt_j
// B/C head: h / (H / G).  A ragged tail (s not a multiple of L) is read as
// x = B = C = 0, dt = 0 — the reference's dt = 0 padding, which leaves the
// state unchanged — and its rows are not written.  The sum order differs
// from the reference's (warp scan, group composition, the products' own
// order), so results agree to a tolerance, not bit for bit.  No atomics:
// a call repeats bit for bit.
//
// bfloat16 (ssd_kernel_state_hb, ssd_kernel_scan_hb): Hopper's usual shape
// of a fast kernel.  A block of the scan takes SSD_HEADS heads of one B/C
// group (their chunks share the B and C tiles), a consumer warpgroup each,
// and a producer warpgroup (setmaxnreg: 40 registers for it, 232 for each
// consumer) whose one thread copies each chunk's x (a tile a head), B and
// C by TMA (CUtensorMaps built on the host each call, passed as a
// __grid_constant__ parameter; rows past s land as zeros) into a ring of
// two stages with full / empty mbarriers; launch 1 takes SSD_STATE_HEADS
// heads a block and a producer warp, and copies x and B.  The maps take
// any row, head and batch strides that are multiples of 16 bytes, so the
// model's x / B / C, views into the conv output, are read where they lie.
// Every product is a wgmma over the chunk's 64 rows (one warpgroup's M),
// with float32 accuracy: B, C and x are bf16 and exact; a float32 operand
// is split into three bf16 parts (v = hi + mid + lo, the top 8 significant
// bits of v, then of each remainder: their sum is v, bit for bit), whose
// products are exact and summed in float32, small parts first.  A
// consumer's chunk:
//   S = S exp(cA_last) + (B dt decay)^T x   S (n x p float32) in the
//       accumulators of its warpgroup through the group; (B dt decay)^T's
//       register-A fragments by ldmatrix.trans from the B tile, scaled and
//       split in registers, all k-steps at once; x read MN-major;
//   C B^T     shared-memory operands, both K-major;
//   C S^T     from the split of S before this chunk's update: three bf16
//       tiles (n rows, p columns, MN-major) written by stmatrix;
//   W' = (C B^T) exp(cA_i - cA_j) dt_j  the accumulators as they lie,
//       masked, one ex2 each for the decay and dt_j, 2^((cA_i - cA_j)
//       log2 e + log2 dt_j), split into the register-A fragments of W' x:
//       dt folded into W's columns, so x, exact, is the other operand;
//   y = (C S^T) exp(cA_i) + W' x, W' x in an accumulator of its own;
//       staged as bf16 by stmatrix in the x tile, then stored as 16-byte
//       pieces, eight lanes a row.
// No plain instruction writes an accumulator while a product is in flight,
// and no product is in flight across a branch: either makes ptxas
// serialise every wgmma of the kernel (C7515), so S is scaled before the
// chunk's products and the group's last chunk updates S too.  What bounds
// the function: at zamba2-1.2b's prefill shape (b = 2, s = 4096, h = 64,
// p = 64, g = 1, n = 64, bf16) a call must move ~138 MB (~0.041 ms at
// 3.35 TB/s) and do ~13 GFLOP of products; the split's parts make ~52
// GFLOP of bf16 products (~0.053 ms at 989 TFLOP/s), and the groups add
// their own traffic, mostly in L2: ~63 MB of f32 group states, x and B
// re-read by launch 1.  What holds it back (PERF.md): with the products
// dropped a call still takes ~60 % of its time; the per-chunk chain of
// one warpgroup (the fragments' splits, the exps, shared memory that the
// C S^T chain reads once a part) runs at two warpgroups an SM, and the
// float32 pass of the group states is launch 2's own.  Each switch below
// is a part of the design that scripts/kernel_probe.py ssd-variants turns
// off (or, for the heads, changes) in turn, timed in turns.
//
// float32 (ssd_kernel_state_f32, ssd_kernel_scan_f32): the CUDA cores,
// 4 x 4 register tiles over float32 operands in shared memory, both read
// as float4 along the contraction index (C, W and B*decay stored
// k-major), so a k-step is 2 shared loads for 16 FMAs; a warp's W (x dt)
// stops at its own rows' diagonal.  256 threads; x/B/C staged by cp.async
// (zero-filled past s) while the current chunk computes.
//
// Layout: x/y (b, s, h, p), dt (b, s, h) float32, A (h,) float32, B/C
// (b, s, g, n); float32 x/B/C and every y dense and 16-byte aligned; bf16
// x/B/C with the last axis dense and the other strides and the base on 16
// bytes.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int L = 64;              // chunk length
constexpr int P = 64;              // head dim
constexpr int GROUP = 8;           // chunks per group
constexpr int THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr int WS = L + 4;          // smem row stride of W^T (conflict-free writes)

__device__ __forceinline__ float to_f(float x) { return x; }

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* states;                   // (b, h, G, N, P) f32
  float* decay;                    // (b, h, G) f32
  int b, s, h, g, G;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int NPEND>                // wait until at most NPEND groups pend
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(NPEND));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// Staging row strides in elements: a row of W elements plus 16 bytes, so
// 16-byte copies stay aligned and ldmatrix rows fall in distinct banks.
template <typename T, int W>
__host__ __device__ constexpr int stage_stride() {
  return W + 16 / int(sizeof(T));
}

// Copy rows [t0, t0 + L) of head `hd` of a (b, s, heads, W) tensor into
// staging; rows >= s are zero-filled.
template <typename T, int W>
__device__ __forceinline__ void stage(T* dst, const T* src, int bb, int s,
                                      int heads, int hd, int t0) {
  constexpr int PER = 16 / int(sizeof(T));   // elements per 16 bytes
  constexpr int CH = W / PER;
  for (int idx = threadIdx.x; idx < L * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH, t = t0 + r;
    const bool in = t < s;
    const T* gp = src + ((size_t(bb) * s + (in ? t : 0)) * heads + hd) * W
                  + PER * c;
    cp_async16(dst + r * stage_stride<T, W>() + PER * c, gp, in ? 16 : 0);
  }
}

// Warp 0: dt of the chunk (two rows a lane, in registers), dA = dt * A,
// its inclusive cumsum by a warp scan; writes dts, cas, dec =
// exp(cA_last - cA) and eca = exp(cA).
__device__ __forceinline__ void chunk_scan_warp0(const float dtr[2],
                                                 float A, float* dts,
                                                 float* cas, float* dec,
                                                 float* eca) {
  const int lane = threadIdx.x;
  const float d0 = dtr[0] * A, d1 = dtr[1] * A;
  float run = d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  const float before = __shfl_up_sync(0xffffffffu, run, 1);
  const float c0 = (lane ? before : 0.f) + d0, c1 = c0 + d1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  dts[2 * lane] = dtr[0];
  dts[2 * lane + 1] = dtr[1];
  cas[2 * lane] = c0;
  cas[2 * lane + 1] = c1;
  dec[2 * lane] = expf(last - c0);
  dec[2 * lane + 1] = expf(last - c1);
  eca[2 * lane] = expf(c0);
  eca[2 * lane + 1] = expf(c1);
}

__device__ __forceinline__ void load_dt(float dtr[2], const SsdArgs& a,
                                        int bb, int hh, int t0) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = t0 + 2 * lane + e;
    dtr[e] = t < a.s ? a.dt[(size_t(bb) * a.s + t) * a.h + hh] : 0.f;
  }
}

// acc[r][c] += sum_{k in [k0, k1)} At[k][4 ti + r] * Bk[k][4 tj + c]
template <int LDA, int LDB>
__device__ __forceinline__ void mm_4x4(float acc[4][4], const float* At,
                                       const float* Bk, int k0, int k1,
                                       int ti, int tj) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&At[k * LDA + 4 * ti]);
    const float4 bv = *reinterpret_cast<const float4*>(&Bk[k * LDB + 4 * tj]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// launch 1: each group's end state from a zero state
// ---------------------------------------------------------------------------

template <int N>
constexpr int state_f32_smem_bytes() {
  using T = float;
  return (L * P + L * N + 4 * L) * 4
         + L * (stage_stride<T, P>() + stage_stride<T, N>()) * int(sizeof(T));
}

template <int N>
__global__ void __launch_bounds__(THREADS) ssd_kernel_state_f32(SsdArgs a) {
  using T = float;
  constexpr int RN = N / 64;       // row blocks of 64 state rows
  extern __shared__ float4 smem4[];
  float* xd = reinterpret_cast<float*>(smem4);   // (L, P): x * dt
  float* bd = xd + L * P;                         // (L, N): B * dec
  float* dts = bd + L * N;
  float* cas = dts + L;
  float* dec = cas + L;
  float* eca = dec + L;
  T* xr = reinterpret_cast<T*>(eca + L);          // staging x
  T* br = xr + L * stage_stride<T, P>();          // staging B

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int grp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int gg = hh / (a.h / a.g);
  const float A = a.A[hh];
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const int nc = (a.s + L - 1) / L;
  const int c0 = grp * GROUP, c1 = min(nc, c0 + GROUP);

  float acc[RN][4][4];
#pragma unroll
  for (int q = 0; q < RN; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][r][c] = 0.f;
  float total = 1.f;               // product of exp(cA_last)
  float dtr[2] = {0.f, 0.f};

  stage<T, P>(xr, x, bb, a.s, a.h, hh, c0 * L);
  stage<T, N>(br, Bm, bb, a.s, a.g, gg, c0 * L);
  cp_async_commit();
  if (tid < 32) load_dt(dtr, a, bb, hh, c0 * L);

  for (int c = c0; c < c1; ++c) {
    cp_async_wait<0>();
    if (tid < 32) chunk_scan_warp0(dtr, A, dts, cas, dec, eca);
    __syncthreads();
    const float e_last = expf(cas[L - 1]);
    total *= e_last;
    for (int idx = tid; idx < L * P; idx += THREADS) {
      const int j = idx / P, p = idx % P;
      xd[idx] = to_f(xr[j * stage_stride<T, P>() + p]) * dts[j];
    }
    for (int idx = tid; idx < L * N; idx += THREADS) {
      const int j = idx / N, n = idx % N;
      bd[idx] = to_f(br[j * stage_stride<T, N>() + n]) * dec[j];
    }
    __syncthreads();
    if (c + 1 < c1) {              // the next chunk loads while this computes
      stage<T, P>(xr, x, bb, a.s, a.h, hh, (c + 1) * L);
      stage<T, N>(br, Bm, bb, a.s, a.g, gg, (c + 1) * L);
      cp_async_commit();
      if (tid < 32) load_dt(dtr, a, bb, hh, (c + 1) * L);
    }
#pragma unroll
    for (int q = 0; q < RN; ++q) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[q][r][cc] *= e_last;
      mm_4x4<N, P>(acc[q], bd + 64 * q, xd, 0, L, ti, tj);
    }
    __syncthreads();               // the next chunk overwrites xd, bd, cas
  }

  float* out = a.states + ((size_t(bb) * a.h + hh) * a.G + grp) * N * P;
#pragma unroll
  for (int q = 0; q < RN; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* row = out + (64 * q + 4 * ti + r) * P;
      *reinterpret_cast<float4*>(row + 4 * tj) =
          make_float4(acc[q][r][0], acc[q][r][1], acc[q][r][2], acc[q][r][3]);
    }
  if (tid == 0) a.decay[(size_t(bb) * a.h + hh) * a.G + grp] = total;
}

// ---------------------------------------------------------------------------
// launch 2: incoming state of every group, in order
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(PASS_THREADS) ssd_kernel_pass(SsdArgs a) {
  constexpr int BATCH = 8;         // end states loaded ahead of the stores
  const int idx = blockIdx.x * PASS_THREADS + threadIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const size_t base = (size_t(bb) * a.h + hh) * a.G;
  float* st = a.states + base * N * P + idx;
  float run = 0.f;
  for (int g0 = 0; g0 + 1 < a.G; g0 += BATCH) {
    float end[BATCH], dec[BATCH];
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const bool in = g0 + e + 1 < a.G;
      end[e] = in ? st[size_t(g0 + e) * N * P] : 0.f;
      dec[e] = in ? a.decay[base + g0 + e] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      if (g0 + e + 1 < a.G) {
        st[size_t(g0 + e) * N * P] = run;
        run = run * dec[e] + end[e];
      }
    }
  }
  st[size_t(a.G - 1) * N * P] = run;
}

// ---------------------------------------------------------------------------
// launch 3: each group's scan from its incoming state
// ---------------------------------------------------------------------------

template <int N>
constexpr int scan_f32_smem_bytes() {
  using T = float;
  return (L * P + 2 * L * N + L * WS + N * P + 4 * L) * 4
         + L * (stage_stride<T, P>() + 2 * stage_stride<T, N>())
         * int(sizeof(T));
}

// W^T[j][i] = (C_i . B_j) exp(cA_i - cA_j) for i >= j: float32 CUDA cores
// on the staging rows
template <int N>
__device__ __forceinline__ void cb_w(const float* cr, const float* br,
                                     const float* cas, float* wt, int ti,
                                     int tj) {
  constexpr int SS = stage_stride<float, N>();
  float cb[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) cb[r][c] = 0.f;
#pragma unroll 2
  for (int n = 0; n < N; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = *reinterpret_cast<const float4*>(&cr[(4 * ti + r) * SS + n]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(&br[(4 * tj + c) * SS + n]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = cb[r][c];
        t = fmaf(cv[r].x, bv[c].x, t);
        t = fmaf(cv[r].y, bv[c].y, t);
        t = fmaf(cv[r].z, bv[c].z, t);
        t = fmaf(cv[r].w, bv[c].w, t);
        cb[r][c] = t;
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * ti + r, j = 4 * tj + c;
      wt[j * WS + i] = i >= j ? cb[r][c] * expf(cas[i] - cas[j]) : 0.f;
    }
}

__device__ __forceinline__ void store_y4(float* row, const float v[4]) {
  *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int N>
__global__ void __launch_bounds__(THREADS) ssd_kernel_scan_f32(SsdArgs a) {
  using T = float;
  constexpr int RN = N / 64;
  constexpr int SX = stage_stride<T, P>(), SN = stage_stride<T, N>();
  extern __shared__ float4 smem4[];
  float* xd = reinterpret_cast<float*>(smem4);   // (L, P): x * dt
  float* bd = xd + L * P;                         // (L, N): B * dec
  float* ct = bd + L * N;                         // (N, L): C^T
  float* wt = ct + N * L;                         // (L, WS): W^T
  float* st = wt + L * WS;                        // (N, P): state^T
  float* dts = st + N * P;
  float* cas = dts + L;
  float* dec = cas + L;
  float* eca = dec + L;
  T* xr = reinterpret_cast<T*>(eca + L);          // staging x, B, C
  T* br = xr + L * SX;
  T* cr = br + L * SN;

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int warp = tid / 32;
  const int grp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int gg = hh / (a.h / a.g);
  const float A = a.A[hh];
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  T* y = static_cast<T*>(a.y);
  const int nc = (a.s + L - 1) / L;
  const int c0 = grp * GROUP, c1 = min(nc, c0 + GROUP);

  float dtr[2] = {0.f, 0.f};
  stage<T, P>(xr, x, bb, a.s, a.h, hh, c0 * L);
  stage<T, N>(br, Bm, bb, a.s, a.g, gg, c0 * L);
  stage<T, N>(cr, Cm, bb, a.s, a.g, gg, c0 * L);
  cp_async_commit();
  if (tid < 32) load_dt(dtr, a, bb, hh, c0 * L);
  if (a.G > 1) {                   // the incoming state from launch 2
    const float4* src = reinterpret_cast<const float4*>(
        a.states + ((size_t(bb) * a.h + hh) * a.G + grp) * N * P);
    for (int idx = tid; idx < N * P / 4; idx += THREADS)
      reinterpret_cast<float4*>(st)[idx] = src[idx];
  } else {
    for (int idx = tid; idx < N * P; idx += THREADS) st[idx] = 0.f;
  }

  for (int c = c0; c < c1; ++c) {
    const int t0 = c * L;
    cp_async_wait<0>();
    if (tid < 32) chunk_scan_warp0(dtr, A, dts, cas, dec, eca);
    __syncthreads();

    // f32 operands, and W from the staging rows
    for (int idx = tid; idx < L * P; idx += THREADS) {
      const int j = idx / P, p = idx % P;
      xd[idx] = to_f(xr[j * SX + p]) * dts[j];
    }
    for (int idx = tid; idx < L * N; idx += THREADS) {
      const int j = idx / N, n = idx % N;
      bd[idx] = to_f(br[j * SN + n]) * dec[j];
    }
    for (int idx = tid; idx < L * N; idx += THREADS) {
      const int i = idx % L, n = idx / L;
      ct[idx] = to_f(cr[i * SN + n]);
    }
    cb_w<N>(cr, br, cas, wt, ti, tj);
    __syncthreads();
    if (c + 1 < c1) {              // the next chunk loads while this computes
      stage<T, P>(xr, x, bb, a.s, a.h, hh, t0 + L);
      stage<T, N>(br, Bm, bb, a.s, a.g, gg, t0 + L);
      stage<T, N>(cr, Cm, bb, a.s, a.g, gg, t0 + L);
      cp_async_commit();
      if (tid < 32) load_dt(dtr, a, bb, hh, t0 + L);
    }

    // y = W (x dt) + (C state^T) exp(cA); W is zero above the diagonal,
    // so a warp's rows (8 w .. 8 w + 7) need j <= 8 w + 7 only
    {
      float yi[4][4], yo[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) yi[r][cc] = yo[r][cc] = 0.f;
      mm_4x4<WS, P>(yi, wt, xd, 0, 8 * warp + 8, ti, tj);
      mm_4x4<L, P>(yo, ct, st, 0, N, ti, tj);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r, t = t0 + i;
        if (t >= a.s) continue;
        const float e = eca[i];
        float v[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) v[cc] = yi[r][cc] + yo[r][cc] * e;
        store_y4(y + ((size_t(bb) * a.s + t) * a.h + hh) * P + 4 * tj, v);
      }
    }

    if (c + 1 < c1) {
      __syncthreads();             // every read of the old state is done
      const float e_last = expf(cas[L - 1]);
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        float u[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) u[r][cc] = 0.f;
        mm_4x4<N, P>(u, bd + 64 * q, xd, 0, L, ti, tj);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* sp = reinterpret_cast<float4*>(
              &st[(64 * q + 4 * ti + r) * P + 4 * tj]);
          const float4 o = *sp;
          *sp = make_float4(o.x * e_last + u[r][0], o.y * e_last + u[r][1],
                            o.z * e_last + u[r][2], o.w * e_last + u[r][3]);
        }
      }
    }
    __syncthreads();               // the next chunk overwrites the tiles
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA, a producer warp (ssd_kernel_state_hb,
// ssd_kernel_scan_hb)
// ---------------------------------------------------------------------------

constexpr int SMEM_OPTIN_BYTES = 232448;   // sm_90: 227 KB a block
constexpr float LOG2E = 1.4426950408889634f;
// the design's parts, each a switch that scripts/kernel_probe.py's
// ssd-variants flips in turn: x / B / C copied by TMA (else by the
// producer warp's cp.async); each product issued while the elementwise
// work beside it runs (else waited for at once); dt folded into W's
// columns, so W' x takes three part products (else x dt is split into
// three bf16 tiles and W x takes six); the heads of one B/C group a block
// of the scan and of launch 1; exp by ex2.approx (else expf).  And two
// diagnostics that break the result, to weigh a part: no exps (every
// decay 1) and no products (no wgmma issued).
constexpr bool SSD_TMA = true;
constexpr bool SSD_OVERLAP = true;
constexpr bool SSD_FOLD = true;
constexpr int SSD_HEADS = 2;
constexpr int SSD_STATE_HEADS = 1;
// the scan's heads a block at n (two heads' tiles and state splits take
// 198 KB at n 128, so three fit at n 64 only)
__host__ __device__ constexpr int hb_heads(int) { return SSD_HEADS; }
constexpr bool SSD_EXP2 = true;
constexpr bool SSD_NO_EXP = false;
constexpr bool SSD_NO_PRODUCTS = false;

constexpr int TILE_BYTES = L * 128;        // 64 rows x 64 bf16 columns
// a warp's scratch: cA, dt, dt exp(cA_last - cA), log2 dt of the chunk
constexpr int SCRATCH_FLOATS = 4 * L;

// the x / B / C maps: boxes of 64 columns x 64 rows of one head (group)
struct HbMaps {
  CUtensorMap x, b, c;
};

struct HbArgs {
  const void* x;                   // (b, s, h, 64) bf16, strides below
  const void* B;                   // (b, s, g, N) bf16
  const void* C;
  const float* dt;                 // (b, s, h) dense
  const float* A;
  void* y;                         // (b, s, h, 64) dense, bf16 or f32
  float* states;                   // (b, h, G, N, P) f32
  float* decay;                    // (b, h, G) f32
  long long xs[3], bs[3], cs[3];   // element strides: head, row, batch
  int b, s, h, g, G;
  int hpg;                         // heads a B/C group
  int sets;                        // blocks a B/C group: ceil(hpg / heads)
};

// a block's shared memory: NSTAGE_TILES tiles a stage (the heads' x, B's
// and C's 64-column chunks), two stages, then (the scan) each head's
// state split, each warp's scratch, the barriers
template <int N, int H, bool SCAN>
struct HbLayout {
  static constexpr int NC = N / 64;                 // 64-column chunks of n
  static constexpr int STAGE_TILES = H + (SCAN ? 2 : 1) * NC;
  static constexpr int STAGE = STAGE_TILES * TILE_BYTES;
  static constexpr int SPLIT = SCAN ? 3 * N * 128 : 0;   // a head's S parts
  static constexpr int SPLITS = 2 * STAGE;
  static constexpr int SCRATCH = SPLITS + H * SPLIT;
  static constexpr int BARS = SCRATCH + 4 * H * SCRATCH_FLOATS * 4;
  // + the producer: a warp (launch 1), a warpgroup that gives its
  // registers to the consumers (the scan: setmaxnreg)
  static constexpr int THREADS = H * 128 + (SCAN ? 128 : 32);
  static constexpr int SMEM = BARS + 4 * 8 + 1024;   // 1024 to align
  static_assert(SMEM <= SMEM_OPTIN_BYTES,
                "ssd hb: tiles exceed the shared memory of a block");
};

// registers a thread of the scan after setmaxnreg: the producer
// warpgroup's 40 (it only copies), the consumers' share of the rest, a
// multiple of 8 (128 x 40 + H x 128 x regs <= 65 536)
constexpr int HB_PRODUCER_REGS = 40;
__host__ __device__ constexpr int hb_consumer_regs(int heads) {
  return (65536 - 128 * HB_PRODUCER_REGS) / (128 * heads) / 8 * 8 > 248
             ? 248
             : (65536 - 128 * HB_PRODUCER_REGS) / (128 * heads) / 8 * 8;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_sync(int wg) {   // one warpgroup
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// ---- mbarriers and TMA (flash_attention.cu's, repeated: each source
// builds alone) ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// the box at (column, head, row, batch) of `map` into `dst`, its bytes
// reported to `bar`; rows past the tensor's end land as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// a K-major tile in the 128-byte swizzle: 1024 bytes between 8-row groups
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16)
       | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// an MN-major tile of one 64-column chunk in the 128-byte swizzle (the B
// operand of a product that contracts over the tile's rows)
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(8192 >> 4) << 16)
       | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// d (64 x 64 f32, the warpgroup's) = [d +] a (64 x 16) . b, a K-major in
// shared memory, b a K-major (16 x 64)^T or (TB) an MN-major 16 x 64 tile
template <int TB>
__device__ __forceinline__ void wgmma_ss(float d[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (SSD_NO_PRODUCTS) return;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}
// d (64 x 64 f32) = [d +] a (64 x 16 bf16, each thread's register
// fragment) . b (16 x 64), b an MN-major tile in shared memory
__device__ __forceinline__ void wgmma_rs(float d[32], const uint32_t a[4],
                                         uint64_t db, int accumulate = 1) {
  if constexpr (SSD_NO_PRODUCTS) return;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N groups of products are in flight (none without
// SSD_OVERLAP: every product is then waited for as soon as it is issued)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n"
               :: "n"(SSD_OVERLAP ? N : 0) : "memory");
}
// keeps the compiler from moving a use of d across a wgmma's issue or wait
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// keeps K fragments in their registers until the products that read them
// have been waited for
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (*a)[4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

// 2^x (SSD_EXP2: ex2.approx, relative error ~2^-22; results below 2^-126
// flush to 0) and log2 x (lg2.approx, absolute error ~2^-22; log2 0 = -inf)
__device__ __forceinline__ float hb_exp2(float x) {
  if constexpr (SSD_NO_EXP) return 1.f;
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float hb_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float hb_exp(float x) {
  if constexpr (SSD_NO_EXP) return 1.f;
  if constexpr (SSD_EXP2) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * LOG2E));
    return y;
  }
  return expf(x);
}

// the three bf16x2 words (hi, mid, lo) of the split of (u, v): the top 8
// significant bits of each value, then of each remainder (the remainders
// are exact), so hi + mid + lo is the value bit for bit
__device__ __forceinline__ void split_pair(float u, float v, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  uint32_t ub = __float_as_uint(u), vb = __float_as_uint(v);
  hi = __byte_perm(ub, vb, 0x7632);
  u -= __uint_as_float(ub & 0xffff0000u);
  v -= __uint_as_float(vb & 0xffff0000u);
  ub = __float_as_uint(u);
  vb = __float_as_uint(v);
  mid = __byte_perm(ub, vb, 0x7632);
  u -= __uint_as_float(ub & 0xffff0000u);
  v -= __uint_as_float(vb & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(u), __float_as_uint(v), 0x7632);
}

// four 8 x 8 bf16 matrices of the mma fragment layout (each thread's
// word of matrix i in r[i]) to shared memory: lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_x4(void* row, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(smem_u32(row)), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// the chunk's dA = dt A and its inclusive cumsum by a warp scan (two rows a
// lane), into this warp's scratch: cA, dt, dt exp(cA_last - cA), log2 dt;
// returns cA_last
__device__ __forceinline__ float hb_scan(const float dtr[2], float A,
                                         float* scr, int lane) {
  const float d0 = dtr[0] * A, d1 = dtr[1] * A;
  float run = d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  const float before = __shfl_up_sync(0xffffffffu, run, 1);
  const float c0 = (lane ? before : 0.f) + d0, c1 = c0 + d1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  scr[2 * lane] = c0;
  scr[2 * lane + 1] = c1;
  scr[L + 2 * lane] = dtr[0];
  scr[L + 2 * lane + 1] = dtr[1];
  scr[2 * L + 2 * lane] = dtr[0] * hb_exp(last - c0);
  scr[2 * L + 2 * lane + 1] = dtr[1] * hb_exp(last - c1);
  scr[3 * L + 2 * lane] = hb_log2(dtr[0]);
  scr[3 * L + 2 * lane + 1] = hb_log2(dtr[1]);
  __syncwarp();
  return last;
}

// dt of rows t0 + 2 lane, + 1 of head hh (0 past s)
__device__ __forceinline__ void hb_load_dt(float dtr[2], const HbArgs& a,
                                           int bb, int hh, int t0, int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = t0 + 2 * lane + e;
    dtr[e] = t < a.s ? a.dt[(size_t(bb) * a.s + t) * a.h + hh] : 0.f;
  }
}

// W' from the C B^T accumulators (the warpgroup's 64 x 64, this thread's
// rows 16 w + g, + 8), decayed, masked and (SSD_FOLD) scaled by dt_j,
// split into the register-A fragments of W' x: wa[part][k-step].  With
// ex2 the decay and dt_j are one exponential, 2^((cA_i - cA_j) log2 e +
// log2 dt_j) (dt_j = 0 gives 2^-inf = 0)
__device__ __forceinline__ void hb_w(const float cb[32], const float* scr,
                                     int w, int g, int t4,
                                     uint32_t (*wa)[4][4]) {
  // the thread's rows, and the last n-tile below their diagonal
  const int ri[2] = {16 * w + g, 16 * w + 8 + g};
  const int top[2] = {2 * w, 2 * w + 1};
  const float ci[2] = {scr[ri[0]], scr[ri[1]]};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 2 * kk + (r >> 1), row = r & 1;   // n-tile, row half
      const int i = ri[row], j = 8 * k + 2 * t4;
      if (k > top[row]) {          // above the diagonal for these 8 rows
        wa[0][kk][r] = wa[1][kk][r] = wa[2][kk][r] = 0u;
        continue;
      }
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float d = ci[row] - scr[j + u];
        float x;
        if constexpr (SSD_EXP2 && SSD_FOLD)
          x = cb[4 * k + 2 * row + u]
              * hb_exp2(__fmaf_rn(d, LOG2E, scr[3 * L + j + u]));
        else if constexpr (SSD_FOLD)
          x = cb[4 * k + 2 * row + u] * hb_exp(d) * scr[L + j + u];
        else
          x = cb[4 * k + 2 * row + u] * hb_exp(d);
        v[u] = i >= j + u ? x : 0.f;
      }
      split_pair(v[0], v[1], wa[0][kk][r], wa[1][kk][r], wa[2][kk][r]);
    }
  }
}

// the split register-A fragments of (B dt decay)^T, rows n of m-block q
// (64 q + 16 w ..), k-step kk (j = 16 kk ..): B^T by ldmatrix.trans from
// the swizzled B tile, scaled by dt_j exp(cA_last - cA_j) and split
__device__ __forceinline__ void hb_bd(const unsigned char* bt,
                                      const float* scr, int q, int kk, int w,
                                      int lane, uint32_t (*bd)[4]) {
  const int j = 16 * kk + (lane & 7) + 8 * (lane >> 4);
  const int pc = 2 * w + ((lane >> 3) & 1);
  uint32_t af[4];
  ldmatrix_x4_trans(af, bt + q * TILE_BYTES + j * 128
                            + ((pc ^ (j & 7)) << 4));
  const float* dd = scr + 2 * L;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int jj = 16 * kk + 2 * (lane & 3) + 8 * (r >> 1);
    const float u = __uint_as_float(af[r] << 16) * dd[jj];
    const float v = __uint_as_float(af[r] & 0xffff0000u) * dd[jj + 1];
    split_pair(u, v, bd[0][r], bd[1][r], bd[2][r]);
  }
}

// S's three parts into the head's split tiles: (n, p) at row n, 128-byte
// swizzled (the MN-major B operand of C S^T), by stmatrix: per m-block and
// part, the warp's 16 rows x 8 n-tiles are 16 8 x 8 matrices, four a
// stmatrix (n-tiles 2 m, 2 m + 1, both row halves)
template <int NC>
__device__ __forceinline__ void hb_store_split(unsigned char* ss,
                                               const float (*S)[32], int w,
                                               int lane) {
  constexpr int PART = NC * TILE_BYTES;
  const int rr = lane & 7, half = (lane >> 3) & 1, odd = lane >> 4;
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int n = 64 * q + 16 * w + 8 * half + rr;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t part[4][3];           // matrices (tile 2 m, 2 m + 1) x halves
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int e = 4 * (2 * m + (f >> 1)) + 2 * (f & 1);
        split_pair(S[q][e], S[q][e + 1], part[f][0], part[f][1], part[f][2]);
      }
      unsigned char* at = ss + n * 128 + (((2 * m + odd) ^ rr) << 4);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        stmatrix_x4(at + p * PART, part[0][p], part[1][p], part[2][p],
                    part[3][p]);
    }
  }
}

// S rows n (64 q + 16 w + g, + 8), columns p (8 k + 2 t4, + 1) of a (N, P)
// f32 slot: read (launch 3's incoming state) or written (launch 1's end)
template <int NC, bool WRITE>
__device__ __forceinline__ void hb_state_io(float* slot, float (*S)[32],
                                            int w, int g, int t4) {
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* at = reinterpret_cast<float2*>(
            slot + (64 * q + 16 * w + g + 8 * r) * P + 8 * k + 2 * t4);
        if constexpr (WRITE) {
          *at = make_float2(S[q][4 * k + 2 * r], S[q][4 * k + 2 * r + 1]);
        } else {
          const float2 v = *at;
          S[q][4 * k + 2 * r] = v.x;
          S[q][4 * k + 2 * r + 1] = v.y;
        }
      }
}

// S += (B dt decay)^T x over the chunk (S scaled by exp(cA_last) and
// fenced before any product of the chunk is issued: no plain instruction
// may write an accumulator while products run, or ptxas serialises every
// wgmma of the kernel, C7515).  The scan's: per m-block q, the four
// k-steps' split fragments built at once (independent chains) into bd[q]
// and the m-block's twelve products issued as one group, the last left in
// flight: the caller waits for it, then fences bd and S
template <int NC>
__device__ __forceinline__ void hb_update(float (*S)[32],
                                          const unsigned char* bt,
                                          const unsigned char* xt,
                                          const float* scr, int w, int lane,
                                          uint32_t (*bd)[4][3][4]) {
#pragma unroll
  for (int q = 0; q < NC; ++q) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hb_bd(bt, scr, q, kk, w, lane, bd[q][kk]);
    wgmma_fence();
#pragma unroll
    for (int part = 2; part >= 0; --part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(S[q], bd[q][kk][part], mn_desc(xt + kk * 16 * 128));
    wgmma_commit();
  }
}
// launch 1's: k-step by k-step, each k-step's fragments built while the
// one before runs (two fragment sets: 96 / 135 registers at n 64 / 128,
// where the scan's batch of every k-step's fragments took launch 1 to 122
// / 164 and fewer blocks an SM), waited for at the end
template <int NC>
__device__ __forceinline__ void hb_update_steps(float (*S)[32],
                                                const unsigned char* bt,
                                                const unsigned char* xt,
                                                const float* scr, int w,
                                                int lane) {
  uint32_t bd[2][3][4];
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int cur = (4 * q + kk) & 1;
      hb_bd(bt, scr, q, kk, w, lane, bd[cur]);
      wgmma_fence();
#pragma unroll
      for (int part = 2; part >= 0; --part)
        wgmma_rs(S[q], bd[cur][part], mn_desc(xt + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait<1>();
      if (4 * q + kk > 0) fence_frags<3>(bd[cur ^ 1]);
    }
  wgmma_wait<0>();
  fence_frags<3>(bd[(4 * NC - 1) & 1]);
#pragma unroll
  for (int q = 0; q < NC; ++q) fence_acc(S[q]);
}
template <int NC>
__device__ __forceinline__ void hb_update_fence(float (*S)[32],
                                                uint32_t (*bd)[4][3][4]) {
#pragma unroll
  for (int q = 0; q < NC; ++q) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_frags<3>(bd[q][kk]);
    fence_acc(S[q]);
  }
}

// ---- the producer: one thread (TMA) or the warp (cp.async) ------------------

// rows [t0, t0 + 64), 64 columns from col of head `hd` of a (b, s, heads,
// .) bf16 tensor with element strides st into a swizzled tile by cp.async
// (rows >= s zeros); the producer warp's 32 lanes, 16 pieces each
__device__ __forceinline__ void hb_cp_tile(unsigned char* dst,
                                           const void* src,
                                           const long long st[3], int bb,
                                           int s, int hd, int t0, int col,
                                           int lane) {
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(src)
      + bb * st[2] + hd * st[0] + col;
#pragma unroll 4
  for (int idx = lane; idx < L * 8; idx += 32) {
    const int r = idx / 8, c = idx % 8, t = t0 + r;
    const bool in = t < s;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               base + (in ? t : 0) * st[1] + 8 * c, in ? 16 : 0);
  }
}

// each chunk of the group into the ring's next stage once its consumers
// have released it: the live heads' x, B's chunks and (the scan) C's
template <int N, int H, bool SCAN>
__device__ __forceinline__ void hb_produce(const HbMaps& maps,
                                          const HbArgs& a,
                                          unsigned char* stages,
                                          uint64_t* full, uint64_t* empty,
                                          int h0, int live, int gg, int bb,
                                          int c0, int c1) {
  using Lt = HbLayout<N, H, SCAN>;
  constexpr int NC = Lt::NC;
  const int lane = threadIdx.x % 32;
  if constexpr (SSD_TMA) {
    if (lane != 0) return;
    for (int c = c0, i = 0; c < c1; ++c, ++i) {
      const int st = i & 1;
      mbar_wait(empty + st, ((i >> 1) & 1) ^ 1);
      unsigned char* d = stages + st * Lt::STAGE;
      mbar_expect(full + st, (live + (SCAN ? 2 : 1) * NC) * TILE_BYTES);
      for (int hd = 0; hd < live; ++hd)
        tma_load(d + hd * TILE_BYTES, &maps.x, full + st, 0, h0 + hd, c * L,
                 bb);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        tma_load(d + (H + q) * TILE_BYTES, &maps.b, full + st, 64 * q, gg,
                 c * L, bb);
        if constexpr (SCAN)
          tma_load(d + (H + NC + q) * TILE_BYTES, &maps.c, full + st, 64 * q,
                   gg, c * L, bb);
      }
    }
  } else {
    // one copy group in flight: chunk i's copies issued, then chunk i -
    // 1's waited for, made visible to wgmma and reported (each lane)
    for (int c = c0, i = 0; c < c1; ++c, ++i) {
      const int st = i & 1;
      mbar_wait(empty + st, ((i >> 1) & 1) ^ 1);
      unsigned char* d = stages + st * Lt::STAGE;
      for (int hd = 0; hd < live; ++hd)
        hb_cp_tile(d + hd * TILE_BYTES, a.x, a.xs, bb, a.s, h0 + hd, c * L, 0,
                   lane);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        hb_cp_tile(d + (H + q) * TILE_BYTES, a.B, a.bs, bb, a.s, gg, c * L,
                   64 * q, lane);
        if constexpr (SCAN)
          hb_cp_tile(d + (H + NC + q) * TILE_BYTES, a.C, a.cs, bb, a.s, gg,
                     c * L, 64 * q, lane);
      }
      cp_async_commit();
      if (i > 0) {
        cp_async_wait<1>();
        fence_proxy_async();
        mbar_arrive(full + (st ^ 1));
      }
    }
    if (c1 > c0) {
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(full + ((c1 - c0 - 1) & 1));
    }
  }
}

// a block's place: its group of chunks, its heads [h0, h0 + live) of B/C
// group gg, its shared memory, its barriers initialised
struct HbPlace {
  int grp, bb, gg, h0, live, c0, c1;
  unsigned char* sm;
  uint64_t *full, *empty;
};

template <int N, int H, bool SCAN>
__device__ __forceinline__ HbPlace hb_place(const HbArgs& a, float4* smem4) {
  using Lt = HbLayout<N, H, SCAN>;
  HbPlace pl;
  pl.sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  pl.grp = blockIdx.x;
  pl.bb = blockIdx.z;
  pl.gg = blockIdx.y / a.sets;
  const int first = (blockIdx.y % a.sets) * H;     // within the group
  pl.h0 = pl.gg * a.hpg + first;
  pl.live = min(H, a.hpg - first);
  const int nc = (a.s + L - 1) / L;
  pl.c0 = pl.grp * GROUP;
  pl.c1 = min(nc, pl.c0 + GROUP);
  pl.full = reinterpret_cast<uint64_t*>(pl.sm + Lt::BARS);
  pl.empty = pl.full + 2;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(pl.full + st, SSD_TMA ? 1 : 32);
      mbar_init(pl.empty + st, 4 * pl.live);   // the live consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return pl;
}

// ---------------------------------------------------------------------------
// launch 1 (bf16): each group's end state from a zero state
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(HbLayout<N, SSD_STATE_HEADS, false>::THREADS,
                                  1)
    ssd_kernel_state_hb(const __grid_constant__ HbMaps maps, HbArgs a) {
  constexpr int H = SSD_STATE_HEADS, NC = N / 64;
  using Lt = HbLayout<N, H, false>;
  extern __shared__ float4 smem4[];
  const HbPlace pl = hb_place<N, H, false>(a, smem4);
  const int wg = threadIdx.x / 128;
  if (wg == H) {                   // the producer warp
    hb_produce<N, H, false>(maps, a, pl.sm, pl.full, pl.empty, pl.h0,
                            pl.live, pl.gg, pl.bb, pl.c0, pl.c1);
    return;
  }
  if (wg >= pl.live) return;       // past the group's heads
  const int hh = pl.h0 + wg, wt = threadIdx.x % 128, w = wt / 32,
            lane = wt % 32;
  float* scr = reinterpret_cast<float*>(pl.sm + Lt::SCRATCH)
               + (threadIdx.x / 32) * SCRATCH_FLOATS;
  const float A = a.A[hh];
  float S[NC][32];
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) S[q][i] = 0.f;
  float total = 1.f;               // the product of exp(cA_last)
  float dtr[2];
  hb_load_dt(dtr, a, pl.bb, hh, pl.c0 * L, lane);
  for (int c = pl.c0, i = 0; c < pl.c1; ++c, ++i) {
    const int st = i & 1;
    const float last = hb_scan(dtr, A, scr, lane);
    if (c + 1 < pl.c1) hb_load_dt(dtr, a, pl.bb, hh, (c + 1) * L, lane);
    const float e_last = hb_exp(last);
    total *= e_last;
    mbar_wait(pl.full + st, (i >> 1) & 1);
    const unsigned char* stage = pl.sm + st * Lt::STAGE;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
#pragma unroll
      for (int j = 0; j < 32; ++j) S[q][j] *= e_last;
      fence_acc(S[q]);
    }
    hb_update_steps<NC>(S, stage + H * TILE_BYTES, stage + wg * TILE_BYTES,
                        scr, w, lane);
    if (lane == 0) mbar_arrive(pl.empty + st);
  }
  const size_t slot = (size_t(pl.bb) * a.h + hh) * a.G + pl.grp;
  hb_state_io<NC, true>(a.states + slot * N * P, S, w, lane / 4, lane % 4);
  if (wt == 0) a.decay[slot] = total;
}

// ---------------------------------------------------------------------------
// launch 3 (bf16): each group's scan from its incoming state
// ---------------------------------------------------------------------------

// YF32: y in float32, a part of a sum over n-blocks that rounds once.
// A consumer's chunk: S scaled by exp(cA_last) and its update issued
// k-step by k-step (its fragments built while the k-step before runs;
// the group's last chunk too, whose new state no one reads);
// C B^T and C S^T (from the split of S before the update) issued behind
// it; W' built from C B^T while C S^T runs, and W' x issued into an
// accumulator of its own; then y = (C S^T) exp(cA_i) + W' x stored and S's
// new split written for the next chunk's C S^T.
template <int N, bool YF32>
__global__ void __launch_bounds__(HbLayout<N, hb_heads(N), true>::THREADS, 1)
    ssd_kernel_scan_hb(const __grid_constant__ HbMaps maps, HbArgs a) {
  constexpr int H = hb_heads(N), NC = N / 64;
  using Lt = HbLayout<N, H, true>;
  extern __shared__ float4 smem4[];
  const HbPlace pl = hb_place<N, H, true>(a, smem4);
  const int wg = threadIdx.x / 128;
  if (wg == H) {                   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(HB_PRODUCER_REGS));
    if (threadIdx.x < H * 128 + 32)
      hb_produce<N, H, true>(maps, a, pl.sm, pl.full, pl.empty, pl.h0,
                             pl.live, pl.gg, pl.bb, pl.c0, pl.c1);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(hb_consumer_regs(H)));
  if (wg >= pl.live) return;       // past the group's heads
  const int hh = pl.h0 + wg, wt = threadIdx.x % 128, w = wt / 32,
            lane = wt % 32, g = lane / 4, t4 = lane % 4;
  float* scr = reinterpret_cast<float*>(pl.sm + Lt::SCRATCH)
               + (threadIdx.x / 32) * SCRATCH_FLOATS;
  unsigned char* ss = pl.sm + Lt::SPLITS + wg * Lt::SPLIT;
  const float A = a.A[hh];

  // the incoming state from launch 2 (zero for one group), and its split
  float S[NC][32];
  if (a.G > 1) {
    hb_state_io<NC, false>(
        a.states + ((size_t(pl.bb) * a.h + hh) * a.G + pl.grp) * N * P, S, w,
        g, t4);
  } else {
#pragma unroll
    for (int q = 0; q < NC; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) S[q][i] = 0.f;
  }
  hb_store_split<NC>(ss, S, w, lane);
  fence_proxy_async();
  wg_sync(wg);
  float dtr[2];
  hb_load_dt(dtr, a, pl.bb, hh, pl.c0 * L, lane);

  for (int c = pl.c0, i = 0; c < pl.c1; ++c, ++i) {
    const int st = i & 1;
    const bool more = c + 1 < pl.c1;
    const float last = hb_scan(dtr, A, scr, lane);
    if (more) hb_load_dt(dtr, a, pl.bb, hh, (c + 1) * L, lane);
    mbar_wait(pl.full + st, (i >> 1) & 1);
    const unsigned char* stage = pl.sm + st * Lt::STAGE;
    const unsigned char* xt = stage + wg * TILE_BYTES;
    const unsigned char* bt = stage + H * TILE_BYTES;
    const unsigned char* ct = bt + NC * TILE_BYTES;
    const float e_last = hb_exp(last);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
#pragma unroll
      for (int j = 0; j < 32; ++j) S[q][j] *= e_last;
      fence_acc(S[q]);
    }

    // S's update first (C S^T below reads the split of S before it), on
    // every chunk: its last k-step runs on into C S^T, and a product in
    // flight across a branch (the group's last chunk needs no update) makes
    // ptxas serialise every wgmma of the kernel (C7515)
    uint32_t bd[NC][4][3][4];
    hb_update<NC>(S, bt, xt, scr, w, lane, bd);
    if constexpr (NC > 1) {        // registers: its fragments go first
      wgmma_wait<0>();
      hb_update_fence<NC>(S, bd);
    }

    // C B^T, then y = C S^T (S's parts, small ones first)
    float cb[32], y[32], yw[32];
    fence_acc(cb);
    fence_acc(y);
    fence_acc(yw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      wgmma_ss<0>(cb, sw128_desc(ct + off), sw128_desc(bt + off), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int part = 2; part >= 0; --part)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<1>(y, sw128_desc(ct + (kk >> 2) * TILE_BYTES + (kk & 3) * 32),
                    mn_desc(ss + part * NC * TILE_BYTES + kk * 16 * 128),
                    part < 2 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();               // the update and C B^T
    fence_acc(cb);
    uint32_t wa[3][4][4];
    hb_w(cb, scr, w, g, t4, wa);
    if constexpr (SSD_FOLD) {
      // yw = W' x: W' (dt folded in) in three parts, x exact
      wgmma_fence();
#pragma unroll
      for (int part = 2; part >= 0; --part)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(yw, wa[part][kk], mn_desc(xt + kk * 16 * 128),
                   part < 2 || kk > 0);
      wgmma_commit();
    } else {
      wgmma_wait<0>();             // C S^T has read the split
      // x dt in three bf16 tiles in the split's place (C S^T has read it),
      // then yw = W (x dt): the six part products down to 2^-24
      {
        const int j = wt / 2;
        const float dj = scr[L + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pc = 4 * (wt % 2) + e;
          const int off = j * 128 + ((pc ^ (j & 7)) << 4);
          const uint4 v = *reinterpret_cast<const uint4*>(xt + off);
          const uint32_t in[4] = {v.x, v.y, v.z, v.w};
          uint32_t part[3][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_pair(__uint_as_float(in[r] << 16) * dj,
                       __uint_as_float(in[r] & 0xffff0000u) * dj, part[0][r],
                       part[1][r], part[2][r]);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            *reinterpret_cast<uint4*>(ss + q * TILE_BYTES + off) =
                make_uint4(part[q][0], part[q][1], part[q][2], part[q][3]);
        }
      }
      fence_proxy_async();
      wg_sync(wg);
      wgmma_fence();
      constexpr int PAIRS[6][2] = {{1, 1}, {2, 0}, {0, 2},
                                   {1, 0}, {0, 1}, {0, 0}};
#pragma unroll
      for (int pr = 0; pr < 6; ++pr)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(yw, wa[PAIRS[pr][0]][kk],
                   mn_desc(ss + PAIRS[pr][1] * TILE_BYTES + kk * 16 * 128),
                   pr > 0 || kk > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int part = 0; part < 3; ++part) fence_frags<4>(wa[part]);
    hb_update_fence<NC>(S, bd);
    fence_acc(y);
    fence_acc(yw);
    const int ri[2] = {16 * w + g, 16 * w + 8 + g};    // the thread's rows
    const float e0 = hb_exp(scr[ri[0]]), e1 = hb_exp(scr[ri[1]]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {    // y = (C S^T) exp(cA_i) + W' x
      y[4 * k] = y[4 * k] * e0 + yw[4 * k];
      y[4 * k + 1] = y[4 * k + 1] * e0 + yw[4 * k + 1];
      y[4 * k + 2] = y[4 * k + 2] * e1 + yw[4 * k + 2];
      y[4 * k + 3] = y[4 * k + 3] * e1 + yw[4 * k + 3];
    }
    const size_t row0 = (size_t(pl.bb) * a.s + c * L) * a.h + hh;
    if constexpr (YF32) {
      if (lane == 0) mbar_arrive(pl.empty + st);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (c * L + ri[r] >= a.s) continue;
        float* out = static_cast<float*>(a.y)
                     + (row0 + size_t(ri[r]) * a.h) * P + 2 * t4;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          *reinterpret_cast<float2*>(out + 8 * k) =
              make_float2(y[4 * k + 2 * r], y[4 * k + 2 * r + 1]);
      }
    } else {
      // y through the warp's rows of the x tile (every product that read it
      // is done): bf16 by stmatrix into the 128-byte swizzle, then each row
      // written back as eight 16-byte pieces by eight lanes
      unsigned char* yt = pl.sm + st * Lt::STAGE + wg * TILE_BYTES;
      const int rr = lane & 7, half = (lane >> 3) & 1, odd = lane >> 4;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t r[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int e = 4 * (2 * m + (f >> 1)) + 2 * (f & 1);
          const __nv_bfloat162 v = __floats2bfloat162_rn(y[e], y[e + 1]);
          r[f] = *reinterpret_cast<const uint32_t*>(&v);
        }
        stmatrix_x4(yt + (16 * w + 8 * half + rr) * 128
                        + (((2 * m + odd) ^ rr) << 4),
                    r[0], r[1], r[2], r[3]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int R = 16 * w + (lane >> 3) + 4 * i, pc = lane & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(
            yt + R * 128 + ((pc ^ (R & 7)) << 4));
        if (c * L + R < a.s)
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.y)
                                    + (row0 + size_t(R) * a.h) * P + 8 * pc) =
              v;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(pl.empty + st);
    }
    if (more) {                    // the new state's split for C S^T
      if (!SSD_FOLD) wg_sync(wg);  // every warp's W (x dt) has read x dt
      hb_store_split<NC>(ss, S, w, lane);
      fence_proxy_async();
      wg_sync(wg);
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the TMA map of a (b, s, heads, cols) bf16 tensor with element strides
// st (head, row, batch; the columns dense) whose boxes are 64 columns of
// 64 rows of one head in the 128-byte swizzle; dimensions innermost first
// (column, head, row, batch); rows past s read as zeros
bool hb_encode(CUtensorMap* map, const void* base, int cols, int heads,
               int s, int b, const long long st[3]) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(cols), cuuint64_t(heads),
                              cuuint64_t(s), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(st[0]) * 2, cuuint64_t(st[1]) * 2,
                                 cuuint64_t(st[2]) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(L), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
int hb_launch(K kernel, int smem, int threads, dim3 grid, const HbMaps& maps,
              const HbArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, threads, smem, s>>>(maps, a);
  return int(cudaGetLastError());
}

// launches 1 and 2 (more than one group), then launch 3 unless
// `states_only`; the heads of a B/C group in sets of the launch's heads a
// block
template <int N, bool YF32>
int launch_hb(const SsdArgs& sa, const long long st[9], bool states_only,
              cudaStream_t s) {
  HbMaps maps;
  std::memset(&maps, 0, sizeof maps);
  if (!hb_encode(&maps.x, sa.x, P, sa.h, sa.s, sa.b, st) ||
      !hb_encode(&maps.b, sa.B, N, sa.g, sa.s, sa.b, st + 3) ||
      !hb_encode(&maps.c, sa.C, N, sa.g, sa.s, sa.b, st + 6))
    return int(cudaErrorInvalidValue);
  HbArgs a;
  std::memset(&a, 0, sizeof a);
  a.x = sa.x;
  a.B = sa.B;
  a.C = sa.C;
  a.dt = sa.dt;
  a.A = sa.A;
  a.y = sa.y;
  a.states = sa.states;
  a.decay = sa.decay;
  for (int i = 0; i < 3; ++i) {
    a.xs[i] = st[i];
    a.bs[i] = st[3 + i];
    a.cs[i] = st[6 + i];
  }
  a.b = sa.b;
  a.s = sa.s;
  a.h = sa.h;
  a.g = sa.g;
  a.G = sa.G;
  a.hpg = sa.h / sa.g;
  int err;
  if (sa.G > 1) {
    using Lt = HbLayout<N, SSD_STATE_HEADS, false>;
    a.sets = (a.hpg + SSD_STATE_HEADS - 1) / SSD_STATE_HEADS;
    err = hb_launch(ssd_kernel_state_hb<N>, Lt::SMEM, Lt::THREADS,
                    dim3(sa.G - 1, sa.g * a.sets, sa.b), maps, a, s);
    if (err) return err;
    ssd_kernel_pass<N><<<dim3(N * P / PASS_THREADS, sa.h, sa.b),
                         PASS_THREADS, 0, s>>>(sa);
    err = int(cudaGetLastError());
    if (err || states_only) return err;
  }
  using Lt = HbLayout<N, hb_heads(N), true>;
  a.sets = (a.hpg + hb_heads(N) - 1) / hb_heads(N);
  return hb_launch(ssd_kernel_scan_hb<N, YF32>, Lt::SMEM, Lt::THREADS,
                   dim3(sa.G, sa.g * a.sets, sa.b), maps, a, s);
}

// launches 1 and 2 (more than one group), then launch 3 unless
// `states_only`: float32
int launch_split(void (*state)(SsdArgs), int state_bytes,
                 void (*pass)(SsdArgs), void (*scan)(SsdArgs),
                 int scan_bytes, int n, const SsdArgs& a, bool states_only,
                 cudaStream_t s) {
  cudaError_t err;
  if (a.G > 1) {
    err = cudaFuncSetAttribute(state,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               state_bytes);
    if (err != cudaSuccess) return int(err);
    state<<<dim3(a.G - 1, a.h, a.b), THREADS, state_bytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    pass<<<dim3(n * P / PASS_THREADS, a.h, a.b), PASS_THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess || states_only) return int(err);
  }
  err = cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             scan_bytes);
  if (err != cudaSuccess) return int(err);
  scan<<<dim3(a.G, a.h, a.b), THREADS, scan_bytes, s>>>(a);
  return int(cudaGetLastError());
}

int dispatch(const SsdArgs& a, const long long st[9], int n, int dtype,
             bool states_only, cudaStream_t s) {
  if (dtype == 0) {                // float32: dense inputs only
    const long long dense[9] = {P,     (long long)a.h * P,
                                (long long)a.s * a.h * P,
                                n,     (long long)a.g * n,
                                (long long)a.s * a.g * n,
                                n,     (long long)a.g * n,
                                (long long)a.s * a.g * n};
    for (int i = 0; i < 9; ++i)
      if (st[i] != dense[i]) return int(cudaErrorInvalidValue);
    if (n == 64)
      return launch_split(ssd_kernel_state_f32<64>,
                          state_f32_smem_bytes<64>(), ssd_kernel_pass<64>,
                          ssd_kernel_scan_f32<64>, scan_f32_smem_bytes<64>(),
                          n, a, states_only, s);
    if (n == 128)
      return launch_split(ssd_kernel_state_f32<128>,
                          state_f32_smem_bytes<128>(), ssd_kernel_pass<128>,
                          ssd_kernel_scan_f32<128>,
                          scan_f32_smem_bytes<128>(), n, a, states_only, s);
  }
  if (dtype == 1 && n == 64) return launch_hb<64, false>(a, st, states_only, s);
  if (dtype == 1 && n == 128)
    return launch_hb<128, false>(a, st, states_only, s);
  if (dtype == 2 && n == 64) return launch_hb<64, true>(a, st, states_only, s);
  if (dtype == 2 && n == 128)
    return launch_hb<128, true>(a, st, states_only, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 (x, B, C and y; dt and A are float32), 2 = bfloat16 x, B,
// C with a float32 y (one n-block's part of a sum).  Supported: chunk 64,
// p 64, n 64 or 128.  `strides`: the element strides of x (head, row,
// batch), of B and of C (group, row, batch), the last axis dense; float32
// takes dense tensors only, bf16 any strides (and bases) on 16 bytes.
// dt and y are dense.  `states` (b, h, G, n, p) and `decay` (b, h, G)
// are float32 scratch for G = ceil(ceil(s / 64) / group) groups, unused
// (may be null) when G = 1; group must be 8.  Launches three kernels (one
// when G = 1) on `stream`, does not synchronise, allocates nothing;
// returns a CUDA error code (0 = success).
extern "C" int ssd_scan_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, void* y, float* states, float* decay, int b, int s, int h,
    int p, int g, int n, int chunk, int group, int dtype, long long xh,
    long long xs, long long xb, long long bg, long long bs, long long bb,
    long long cg, long long cs, long long cb, void* stream) {
  if (b < 0 || s < 0 || h < 1 || g < 1 || h % g != 0 || b > 65535 ||
      h > 65535)
    return int(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return 0;
  if (chunk != L || p != P || group != GROUP)
    return int(cudaErrorInvalidValue);
  const int G = ((s + L - 1) / L + GROUP - 1) / GROUP;
  if (G > 1 && (states == nullptr || decay == nullptr))
    return int(cudaErrorInvalidValue);
  const SsdArgs a{x, dt, A, B, C, y, states, decay, b, s, h, g, G};
  const long long st[9] = {xh, xs, xb, bg, bs, bb, cg, cs, cb};
  return dispatch(a, st, n, dtype, false, static_cast<cudaStream_t>(stream));
}

// The incoming state of every group (launches 1 and 2 alone) into
// `states` (b, h, G, n, p): for the checks that hold the split products to
// the float32 tolerance.  Arguments as ssd_scan_launch without y; needs
// G > 1.
extern "C" int ssd_scan_states_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, float* states, float* decay, int b, int s, int h, int p,
    int g, int n, int chunk, int group, int dtype, long long xh, long long xs,
    long long xb, long long bg, long long bs, long long bb, long long cg,
    long long cs, long long cb, void* stream) {
  if (b < 1 || s < 1 || h < 1 || g < 1 || h % g != 0 || b > 65535 ||
      h > 65535 || chunk != L || p != P || group != GROUP ||
      states == nullptr || decay == nullptr)
    return int(cudaErrorInvalidValue);
  const int G = ((s + L - 1) / L + GROUP - 1) / GROUP;
  if (G < 2) return int(cudaErrorInvalidValue);
  const SsdArgs a{x, dt, A, B, C, nullptr, states, decay, b, s, h, g, G};
  const long long st[9] = {xh, xs, xb, bg, bs, bb, cg, cs, cb};
  return dispatch(a, st, n, dtype, true, static_cast<cudaStream_t>(stream));
}

// The heads of one B/C group a bf16 block takes at n (64 or 128):
// `launch` 1 (the groups' end states) or 3 (the scan); kernels/ssd_scan.py
// checks its own.
extern "C" int ssd_scan_heads(int launch, int n) {
  return launch == 1 ? SSD_STATE_HEADS : hb_heads(n);
}
#endif
