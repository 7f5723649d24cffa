// The gradient of the Mamba2 SSD chunked scan for Hopper (sm_90a)
// [arXiv:2405.21060]: given dy, the gradients of x, dt, A, B and C of the
// scan from a zero state; float32 or bfloat16 x/B/C/dy.  Narrower p and n
// arrive zero-padded (dy too) from the wrapper, as in the forward; wider
// ones in the forward's blocks (kernels/ssd_scan.py `ssd_blocked_bwd`):
// p-blocks as heads, one call an n-block from that block's group states,
// the wrapper summing dx, ddt and dA over the n-blocks and laying their dB
// and dC side by side.  A bf16 call of such a sum writes a float32 dx
// (dtype 2, the DXF32 instances), so dx rounds to bf16 once.
//
// It differentiates what csrc/ssd_scan.cu computes, the TPU Pallas kernel
// src/repro/kernels/ssd_scan.py:_ssd_kernel (launcher `ssd_scan`).  The
// reference has no backward kernel: it takes XLA's gradient of
// nn/ssd.ssd_chunked.  This kernel is written from the gradient equations,
// per chunk of L = 64 rows of one (batch, head), with a = dt A, c its
// inclusive cumsum, u = dt x, S the chunk's incoming state (P x N), dS' the
// gradient of its outgoing state and E_ij = exp(c_i - c_j) for i >= j:
//
//   W = (C B^T) o E           G = dy u^T            GE = G o E
//   du_j = sum_{i>=j} W_ij dy_i + exp(c_L - c_j) dS' B_j     dx = dt du
//   dC_i = sum_{j<=i} GE_ij B_j + exp(c_i) S^T dy_i
//   dB_j = sum_{i>=j} GE_ij C_i + exp(c_L - c_j) dS'^T u_j
//   dc_i = sum_j (W o G)_ij - sum_k (W o G)_ki + exp(c_i) C_i . S^T dy_i
//          - r_i, r_j = exp(c_L - c_j) u_j . dS' B_j; the last row adds
//          exp(c_L) <dS', S> + sum_j r_j
//   da = reverse cumsum of dc, ddt = x . du + A da, dA += sum dt da
//   dS = exp(c_L) dS' + sum_i exp(c_i) dy_i C_i^T   (to the chunk before)
//
// The forward keeps its group states (the float32 incoming state of each
// group of GROUP chunks, which its launch 2 writes).  States are kept here
// as (N, P): S[n][p].
//
// bfloat16 (ssd_bwd_walk_hb, ssd_bwd_chunk_hb): Hopper's shape of a fast
// kernel, as the forward's bf16 launches.  Three launches (two when one
// group holds every chunk):
//
//   1. ssd_bwd_walk_hb, grid (2 G, h, b), a head a block: blocks x < G walk
//      their group's chunks forward from the saved group state and write
//      each chunk's incoming state S (b, h, nc, N, P); blocks x >= G walk
//      them in reverse from a zero gradient and write, for each chunk, the
//      part of dS' that the group's own later rows give (b, h, nc, N, P)
//      and the product of the decays of the group's chunks after it (b, h,
//      nc); at the group's first chunk that walk holds the group's own
//      incoming-state gradient and decay, which it writes for the pass.
//      Each step is X <- exp(c_L) X + (M v)^T Y: (M, v, Y) = (B, exp(c_L -
//      c) dt, x) forward, (C, exp(c), dy) in reverse; (M v)^T the
//      register-A fragments of a wgmma, by ldmatrix.trans from the M tile,
//      scaled and split, Y exact and MN-major; thread 0 copies the next
//      chunk's M and Y tiles by TMA into the other of two stages while
//      this one computes.  SB_SKIP_SLABS: a group's first chunk's state
//      (the group state itself, or zero) and its last chunk's local
//      gradient (zero) are not written; launch 3 takes them where they
//      are.
//   2. ssd_bwd_pass, grid (N P / 256, h, b): walks the groups from the last
//      to the first and leaves in each slot the gradient of that group's
//      outgoing state (no launch when G = 1);
//   3. ssd_bwd_chunk_hb, grid (nc, g * nsplit, b): one chunk and up to
//      HEADS heads of one B/C group, one head after another in one
//      warpgroup.  Its thread 0 copies the chunk's B and C once and each
//      head's x and dy by TMA into a ring of sb_stages(N) stages with full
//      mbarriers (a stage is free again after the barrier that ends the
//      head that read it: at n 64 one stage, the next head's tiles copied
//      from that barrier on, timed faster than two), and asks the L2 for the
//      head's float32 slabs (S, the local dS', the group's outgoing
//      gradient) ahead of the warpgroup's loads, which are issued at
//      once, with no branch between them.  No producer warp: a block of
//      128 threads keeps 255 registers a thread at two blocks an SM (a
//      fifth warp cut that to 168, and ptxas serialised every wgmma,
//      C7512).  A head, in three phases:
//        (A) S split into three bf16 tiles (rows n, the K-major B operand
//            of dy S^T); dC = exp(c_i) dy S^T with rows i, kept in the
//            accumulators, and q_i = C_i . dC_i beside it;
//        (C) dy x^T (rows i): G o E, dt_j folded into the exponent
//            (SB_FOLD), split, register-A; dC += (G o E) B on top of
//            (A)'s accumulators; then dS' = local + decay x the group's
//            outgoing gradient split into the same tiles, <dS', S>;
//        (B) B C^T and x dy^T (rows j), so that W^T and (G o E)^T are the
//            accumulators as they lie: W^T dy (W^T split, register-A; dy
//            MN-major) and B dS' (dS' MN-major) give du, dx and x . du;
//            (G o E)^T C and x dS'^T give dB; the row and column sums of
//            W o G.
//      dB and dC sum over the block's heads in head order in float32 tiles
//      of shared memory (each element by the thread that owns it, float2
//      at a time, the columns swizzled by row so a warp's 8 rows fall in
//      distinct banks) and go out as one float32 row (b, s, g * nsplit,
//      N) for them: the wrapper sums the nsplit = ceil((h / g) / HEADS)
//      rows of each group.  dA goes out per (batch, head, chunk).
//
// A float32 operand is split into three bf16 parts (v = hi + mid + lo, the
// top 8 significant bits of v, then of each remainder: their sum is v, bit
// for bit) whose products are exact and summed in float32, small parts
// first; the other operand is exact bf16 (x, dy, B, C).  So the error is
// float32 rounding, as in the forward's bf16 path.  No product is in
// flight across a branch and no plain instruction writes an accumulator
// while products run (either serialises every wgmma of the kernel,
// C7515): each product group is waited for before the code that follows
// it branches.  Each SB_* switch is a part of the design that
// scripts/kernel_probe.py ssd-bwd-variants turns off (or changes) in turn,
// timed in turns.
//
// float32: on the CUDA cores: 4 x 4 register tiles per
// thread over float32 operands in shared memory read as float4 (`mm`),
// three launches (chunk states and each group's own state gradient; the
// pass; each group's chunks in reverse from that gradient, carrying dS in
// shared memory), per-head float32 dB and dC rows (b, s, h, N) and dA per
// (batch, head, group).
//
// No atomics: every output element is written by one thread in a fixed
// order, so two runs give the same bits.  A ragged tail reads as x = B =
// C = dy = 0, dt = 0, and its rows are not written.
//
// Layout: x/dy/dx (b, s, h, p), dt/ddt (b, s, h) float32, A (h,) float32,
// B/C (b, s, g, n); float32 all contiguous and 16-byte aligned; bf16 x /
// dy / B / C with the last axis dense and the other strides and the base
// on 16 bytes (the TMA maps read the model's views where they lie); dx
// dense.
//
// What bounds it: at zamba2's shape (b = 2, s = 4096, h = 64, p = 64,
// g = 1, n = 64, bf16) the function moves ~209 MB (x, dy, dx, B, C, dB,
// dC, dt, ddt: ~0.062 ms at 3.35 TB/s) and does ~2.5 x the forward's
// ~13 GFLOP of products (~0.033 ms on the bf16 tensor cores), so it is
// bound by bytes.  The bf16 design moves ~0.47 GB of float32 chunk states
// and local gradients through memory beside that (written by launch 1,
// read by launch 3) and runs ~3x the function's products through the
// split; what holds it back is in PERF.md.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int L = 64;              // chunk length
constexpr int P = 64;              // head dim
constexpr int GROUP = 8;           // chunks per group (the forward's)
constexpr int THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr int HEADS = 8;           // heads of one B/C group a chunk block takes

// shared-memory row stride of a tile of W columns: float4 rows that start
// 16 bytes apart in the bank map
__host__ __device__ constexpr int ld(int w) { return w + 4; }

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  const float* states;             // (b, h, G, N, P) forward group states
  float* cstates;                  // (b, h, nc, N, P) chunk incoming states
  float* dstates;                  // (b, h, G, N, P) group state gradients
  float* gdecay;                   // (b, h, G)
  float* dsloc;                    // bf16: (b, h, nc, N, P) local dS'
  float* facs;                     // bf16: (b, h, nc) decay after the chunk
  void* dx;
  float* ddt;
  float* dBp;                      // (b, s, R, N): R = h (f32), g nsplit (bf16)
  float* dCp;
  float* dAp;                      // (b, h, G) f32; (b, h, nc) bf16
  int b, s, h, g, G, nc, nsplit;
};

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

// rows [t0, t0 + L) of head `hd` of a (b, s, heads, W) float32 tensor into
// a tile of stride ld(W); rows >= s read as 0
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const void* src_,
                                          int bb, int s, int heads, int hd,
                                          int t0) {
  const float* src = static_cast<const float*>(src_);
  for (int idx = threadIdx.x; idx < L * W; idx += THREADS) {
    const int r = idx / W, c = idx % W, t = t0 + r;
    dst[r * ld(W) + c] =
        t < s ? src[((size_t(bb) * s + t) * heads + hd) * W + c] : 0.f;
  }
}

// an (N, P) float32 state into a tile of stride ld(P)
template <int N>
__device__ __forceinline__ void load_state(float* dst, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int idx = threadIdx.x; idx < N * P / 4; idx += THREADS) {
    const int n = idx / (P / 4), c = idx % (P / 4);
    *reinterpret_cast<float4*>(dst + n * ld(P) + 4 * c) = s4[idx];
  }
}

// Warp 0: dt of a chunk, two rows a lane (0 past s)
__device__ __forceinline__ void load_dt(float dtr[2], const BwdArgs& a,
                                         int bb, int hh, int t0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = t0 + 2 * lane + e;
    dtr[e] = t < a.s ? a.dt[(size_t(bb) * a.s + t) * a.h + hh] : 0.f;
  }
}

// Warp 0: the chunk's cumsum of a = dt A from dt in registers (two rows a
// lane, the forward's order): dts, cas = c, eca = exp(c), dec =
// exp(c_L - c)
__device__ __forceinline__ void chunk_cumsum(const float dtr[2], float A,
                                        float* dts, float* cas, float* eca,
                                        float* dec) {
  const int lane = threadIdx.x & 31;
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
  eca[2 * lane] = expf(c0);
  eca[2 * lane + 1] = expf(c1);
  dec[2 * lane] = expf(last - c0);
  dec[2 * lane + 1] = expf(last - c1);
}

// acc[r][c] += sum_{k < K} X(i0 + r, k) (sc[k]) Y(k, j0 + c), where
// X(i, k) = XK ? X[k ldx + i] : X[i ldx + k] and
// Y(k, j) = YK ? Y[k ldy + j] : Y[j ldy + k]; every read a float4
template <bool XK, bool YK, bool SC>
__device__ __forceinline__ void mm(float acc[4][4], const float* X, int ldx,
                                   const float* Y, int ldy, const float* sc,
                                   int K, int i0, int j0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float xv[4][4], yv[4][4];      // [row][k - k0], [column][k - k0]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(
          XK ? X + (k + q) * ldx + i0 : X + (i0 + q) * ldx + k);
      const float4 b = *reinterpret_cast<const float4*>(
          YK ? Y + (k + q) * ldy + j0 : Y + (j0 + q) * ldy + k);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (XK) xv[e][q] = av[e]; else xv[q][e] = av[e];
        if (YK) yv[e][q] = bv[e]; else yv[q][e] = bv[e];
      }
    }
    if (SC) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float f = sc[k + q];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r][q] *= f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r][q], yv[c][q], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float t[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) t[r][c] = 0.f;
}

// sum over the 16 threads of a half-warp (the threads of one tile row)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// launch 1 (float32): chunk states, each group's own state gradient and
// decay

template <int N>
constexpr int state_smem_bytes() {
  return (2 * L * ld(P) + 2 * L * ld(N) + 5 * L) * 4;
}

template <int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_state_f32(BwdArgs a) {
  constexpr int RN = N / 64;       // row blocks of 64 state rows
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // (L, P)
  float* dys = xs + L * ld(P);                   // (L, P)
  float* Bs = dys + L * ld(P);                   // (L, N)
  float* Cs = Bs + L * ld(N);                    // (L, N)
  float* dts = Cs + L * ld(N);
  float* cas = dts + L;
  float* eca = cas + L;
  float* dec = eca + L;
  float* sdec = dec + L;                         // dec dt

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int grp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int gg = hh / (a.h / a.g);
  const float A = a.A[hh];
  const int c0 = grp * GROUP, c1 = min(a.nc, c0 + GROUP);
  const size_t bh = size_t(bb) * a.h + hh;

  float st[RN][4][4], ds[RN][4][4];              // rows 64 q + 4 ti + r
#pragma unroll
  for (int q = 0; q < RN; ++q) {
    zero(ds[q]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a.states != nullptr)
        v = *reinterpret_cast<const float4*>(
            a.states + (bh * a.G + grp) * N * P + (64 * q + 4 * ti + r) * P
            + 4 * tj);
      st[q][r][0] = v.x; st[q][r][1] = v.y; st[q][r][2] = v.z; st[q][r][3] = v.w;
    }
  }
  float D = 1.f;                   // product of the decays of the chunks so far

  for (int c = c0; c < c1; ++c) {
    const int t0 = c * L;
    const bool more = c + 1 < c1;
    float* out = a.cstates + (bh * a.nc + c) * N * P;
#pragma unroll
    for (int q = 0; q < RN; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store4(out + (64 * q + 4 * ti + r) * P + 4 * tj, st[q][r]);
    if (more) {
      load_rows<P>(xs, a.x, bb, a.s, a.h, hh, t0);
      load_rows<N>(Bs, a.B, bb, a.s, a.g, gg, t0);
    }
    if (grp > 0) {
      load_rows<P>(dys, a.dy, bb, a.s, a.h, hh, t0);
      load_rows<N>(Cs, a.C, bb, a.s, a.g, gg, t0);
    }
    if (tid < 32) {
      float dtr[2];
      load_dt(dtr, a, bb, hh, t0);
      chunk_cumsum(dtr, A, dts, cas, eca, dec);
    }
    __syncthreads();
    if (tid < L) sdec[tid] = dec[tid] * dts[tid];
    __syncthreads();
    const float last = expf(cas[L - 1]);
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      float t[4][4];
      if (grp > 0) {               // + D sum_i C_i^T exp(c_i) dy_i
        zero(t);
        mm<true, true, true>(t, Cs + 64 * q, ld(N), dys, ld(P), eca, L,
                             4 * ti, 4 * tj);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[q][r][e] += D * t[r][e];
      }
      if (more) {                  // S <- exp(c_L) S + sum_j B_j^T dec_j dt_j x_j
        zero(t);
        mm<true, true, true>(t, Bs + 64 * q, ld(N), xs, ld(P), sdec, L,
                             4 * ti, 4 * tj);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[q][r][e] = st[q][r][e] * last + t[r][e];
      }
    }
    D *= last;
    __syncthreads();               // the next chunk overwrites the tiles
  }
  if (grp > 0) {
    float* out = a.dstates + (bh * a.G + grp) * N * P;
#pragma unroll
    for (int q = 0; q < RN; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store4(out + (64 * q + 4 * ti + r) * P + 4 * tj, ds[q][r]);
  }
  if (tid == 0) a.gdecay[bh * a.G + grp] = D;
}

// launch 2 (both dtypes): the gradient of every group's outgoing state,
// last to first

template <int N>
__global__ void __launch_bounds__(PASS_THREADS) ssd_bwd_pass(BwdArgs a) {
  constexpr int BATCH = 8;         // own gradients loaded ahead of the stores
  const int idx = blockIdx.x * PASS_THREADS + threadIdx.x;
  const size_t base = (size_t(blockIdx.z) * a.h + blockIdx.y) * a.G;
  float* ds = a.dstates + base * N * P + idx;
  float run = 0.f;                 // the last group's outgoing gradient
  for (int top = a.G - 1; top > 0; top -= BATCH) {
    float own[BATCH], dec[BATCH];
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int grp = top - e;
      own[e] = grp > 0 ? ds[size_t(grp) * N * P] : 0.f;
      dec[e] = grp > 0 ? a.gdecay[base + grp] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int grp = top - e;
      if (grp > 0) {
        ds[size_t(grp) * N * P] = run;
        run = own[e] + dec[e] * run;
      }
    }
  }
  ds[0] = run;
}

// launch 3 (float32): each group's chunks in reverse

constexpr int VEC = 9 * L + 8 * L + 32;    // per-row vectors and scratch

template <int N>
constexpr int scan_smem_bytes() {
  return (2 * L * ld(P) + 2 * L * ld(N) + 2 * N * ld(P) + 2 * L * ld(L) + VEC)
         * 4;
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_scan_f32(BwdArgs a) {
  constexpr int RN = N / 64;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // (L, P)
  float* dys = xs + L * ld(P);                   // (L, P)
  float* Bs = dys + L * ld(P);                   // (L, N)
  float* Cs = Bs + L * ld(N);                    // (L, N)
  float* St = Cs + L * ld(N);                    // (N, P) incoming state
  float* dSt = St + N * ld(P);                   // (N, P) dS'
  float* Ws = dSt + N * ld(P);                   // (L, L) W
  float* GEs = Ws + L * ld(L);                   // (L, L) G o E
  float* dts = GEs + L * ld(L);
  float* cas = dts + L;
  float* eca = cas + L;
  float* dec = eca + L;
  float* rowM = dec + L;                         // row sums of W o G
  float* dcM = rowM + L;                         // rowM - column sums
  float* rr = dcM + L;                           // r_j
  float* qq = rr + L;                            // exp(c_i) C_i . S^T dy_i
  float* ddtd = qq + L;                          // x_j . du_j
  float* colp = ddtd + L;                        // (8 warps, L)
  float* red = colp + 8 * L;                     // (32)

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int grp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int gg = hh / (a.h / a.g);
  const float A = a.A[hh];
  const int c0 = grp * GROUP, c1 = min(a.nc, c0 + GROUP);
  const size_t bh = size_t(bb) * a.h + hh;
  float* dx = static_cast<float*>(a.dx);

  if (a.G > 1)
    load_state<N>(dSt, a.dstates + (bh * a.G + grp) * N * P);
  else
    for (int idx = tid; idx < N * P; idx += THREADS)
      dSt[(idx / P) * ld(P) + idx % P] = 0.f;
  float dA_acc = 0.f;              // warp 0: sum of dt da over the group

  for (int c = c1 - 1; c >= c0; --c) {
    const int t0 = c * L;
    load_rows<P>(xs, a.x, bb, a.s, a.h, hh, t0);
    load_rows<P>(dys, a.dy, bb, a.s, a.h, hh, t0);
    load_rows<N>(Bs, a.B, bb, a.s, a.g, gg, t0);
    load_rows<N>(Cs, a.C, bb, a.s, a.g, gg, t0);
    load_state<N>(St, a.cstates + (bh * a.nc + c) * N * P);
    if (tid < 32) {
      float dtr[2];
      load_dt(dtr, a, bb, hh, t0);
      chunk_cumsum(dtr, A, dts, cas, eca, dec);
    }
    __syncthreads();

    // W = (C B^T) o E and GE = (dy u^T) o E on this thread's 4 x 4 tile
    // (rows i = 4 ti + r, columns j = 4 tj + e), with the row and column
    // sums of W o G
    {
      float cb[4][4], gx[4][4];
      zero(cb);
      zero(gx);
      mm<false, false, false>(cb, Cs, ld(N), Bs, ld(N), nullptr, N, 4 * ti,
                              4 * tj);
      mm<false, false, false>(gx, dys, ld(P), xs, ld(P), nullptr, P, 4 * ti,
                              4 * tj);
      float rs[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        float w[4], ge[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * tj + e;
          const float ee = i >= j ? expf(cas[i] - cas[j]) : 0.f;
          const float gv = gx[r][e] * dts[j];
          w[e] = cb[r][e] * ee;
          ge[e] = gv * ee;
          const float m = w[e] * gv;
          rs[r] += m;
          cs[e] += m;
        }
        store4(Ws + i * ld(L) + 4 * tj, w);
        store4(GEs + i * ld(L) + 4 * tj, ge);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = row_sum(rs[r]);
        if (tj == 0) rowM[4 * ti + r] = v;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = cs[e] + __shfl_xor_sync(0xffffffffu, cs[e], 16);
        if (lane < 16) colp[warp * L + 4 * tj + e] = v;
      }
    }
    __syncthreads();
    if (tid < L) {
      float col = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) col += colp[w * L + tid];
      dcM[tid] = rowM[tid] - col;
    }

    // du = W^T dy + dec (B dS'^T): rows j = 4 ti + r, columns p = 4 tj + e;
    // dx = dt du, x . du and r_j = dt_j x_j . dec_j (dS' B_j)
    {
      float du[4][4], dus[4][4];
      zero(du);
      zero(dus);
      mm<true, true, false>(du, Ws, ld(L), dys, ld(P), nullptr, L, 4 * ti,
                            4 * tj);
      mm<false, true, false>(dus, Bs, ld(N), dSt, ld(P), nullptr, N, 4 * ti,
                             4 * tj);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * ti + r, t = t0 + j;
        const float dj = dec[j], dtj = dts[j];
        float v[4], xd = 0.f, xr = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = dus[r][e] * dj;
          const float tot = du[r][e] + sv;
          const float xv = xs[j * ld(P) + 4 * tj + e];
          xd += xv * tot;
          xr += xv * sv;
          v[e] = tot * dtj;
        }
        if (t < a.s) store4(dx + ((size_t(bb) * a.s + t) * a.h + hh) * P
                            + 4 * tj, v);
        xd = row_sum(xd);
        xr = row_sum(xr);
        if (tj == 0) {
          ddtd[j] = xd;
          rr[j] = xr * dtj;
        }
      }
    }

    // dC = GE B + exp(c) (dy S): rows i, columns n = 64 q + 4 tj + e;
    // q_i = exp(c_i) C_i . (S^T dy_i)
    {
      float qp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        float a1[4][4], a2[4][4];
        zero(a1);
        zero(a2);
        mm<false, true, false>(a1, GEs, ld(L), Bs + 64 * q, ld(N), nullptr,
                               L, 4 * ti, 4 * tj);
        mm<false, false, false>(a2, dys, ld(P), St + 64 * q * ld(P), ld(P),
                                nullptr, P, 4 * ti, 4 * tj);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ti + r, t = t0 + i;
          const float e_i = eca[i];
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float inter = a2[r][e] * e_i;
            v[e] = a1[r][e] + inter;
            qp[r] += Cs[i * ld(N) + 64 * q + 4 * tj + e] * inter;
          }
          if (t < a.s) store4(a.dCp + ((size_t(bb) * a.s + t) * a.h + hh) * N
                              + 64 * q + 4 * tj, v);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = row_sum(qp[r]);
        if (tj == 0) qq[4 * ti + r] = v;
      }
    }

    // dB = GE^T C + dec dt (x dS'): rows j, columns n
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      float b1[4][4], b2[4][4];
      zero(b1);
      zero(b2);
      mm<true, true, false>(b1, GEs, ld(L), Cs + 64 * q, ld(N), nullptr, L,
                            4 * ti, 4 * tj);
      mm<false, false, false>(b2, xs, ld(P), dSt + 64 * q * ld(P), ld(P),
                              nullptr, P, 4 * ti, 4 * tj);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * ti + r, t = t0 + j;
        const float f = dec[j] * dts[j];
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = b1[r][e] + f * b2[r][e];
        if (t < a.s) store4(a.dBp + ((size_t(bb) * a.s + t) * a.h + hh) * N
                            + 64 * q + 4 * tj, v);
      }
    }

    // <dS', S>
    {
      float part = 0.f;
      for (int idx = tid; idx < N * P; idx += THREADS) {
        const int o = (idx / P) * ld(P) + idx % P;
        part += dSt[o] * St[o];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();               // every read of dS' is done

    // warp 0: dc, da = its reverse cumsum, ddt, the dA sum
    if (warp == 0) {
      const int i0 = 2 * lane, i1 = i0 + 1;
      float rsum = rr[i0] + rr[i1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) dot += red[w];
      const float d0 = dcM[i0] + qq[i0] - rr[i0];
      float d1 = dcM[i1] + qq[i1] - rr[i1];
      if (i1 == L - 1) d1 += expf(cas[L - 1]) * dot + rsum;
      float run = d0 + d1;         // suffix sums over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, run, off);
        if (lane + off < 32) run += o;
      }
      const float da0 = run, da1 = run - d0;
      const float das[2] = {da0, da1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = i0 + e, t = t0 + k;
        if (t < a.s)
          a.ddt[(size_t(bb) * a.s + t) * a.h + hh] = ddtd[k] + A * das[e];
        dA_acc += dts[k] * das[e];
      }
    }

    // dS <- exp(c_L) dS' + sum_i C_i^T exp(c_i) dy_i, in place (each
    // element by the thread that reads it)
    {
      const float last = expf(cas[L - 1]);
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        float u[4][4];
        zero(u);
        mm<true, true, true>(u, Cs + 64 * q, ld(N), dys, ld(P), eca, L,
                             4 * ti, 4 * tj);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float* row = dSt + (64 * q + 4 * ti + r) * ld(P) + 4 * tj;
          const float4 o = *reinterpret_cast<const float4*>(row);
          const float v[4] = {o.x * last + u[r][0], o.y * last + u[r][1],
                              o.z * last + u[r][2], o.w * last + u[r][3]};
          store4(row, v);
        }
      }
    }
    __syncthreads();               // the next chunk overwrites the tiles
  }
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dA_acc += __shfl_xor_sync(0xffffffffu, dA_acc, off);
    if (lane == 0) a.dAp[bh * a.G + grp] = dA_acc;
  }
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA (ssd_bwd_walk_hb, ssd_bwd_chunk_hb)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int SMEM_OPTIN_BYTES = 232448;   // sm_90: 227 KB a block
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE_BYTES = L * 128;        // 64 rows x 64 bf16 columns
constexpr int HB_THREADS = 128;            // a warpgroup; thread 0 copies
constexpr int WALK_STAGES = 2;             // launch 1's ring
// the design's parts, each a switch that scripts/kernel_probe.py's
// ssd-bwd-variants flips in turn: dt_j folded into the exponent of G o E
// (else a multiply); launch 3's stages and branch-free loads at n 64 and
// n 128 (sb_stages, sb_branchless); the float32 slabs asked of the L2
// ahead of the warpgroup's loads; the slabs launch 3 can take elsewhere
// not written by the walks; the heads of one B/C group a chunk block
// takes (HEADS, above); the chunk blocks an SM at n 64 (1: its shared
// memory padded to take the SM)
constexpr bool SB_FOLD = true;
// launch 3 at n 64 and at n 128 (PERF.md, ssd-bwd-variants): the stages
// of its ring of x / dy tiles; the three float32 slabs' loads issued at
// once, without a branch between them (at n 128 they spill)
__host__ __device__ constexpr int sb_stages(int n) { return n == 64 ? 1 : 2; }
__host__ __device__ constexpr bool sb_branchless(int n) { return n == 64; }
constexpr bool SB_PREFETCH = true;
constexpr bool SB_SKIP_SLABS = true;
constexpr int SB_BLOCKS_N64 = 2;

// a warp's scratch: c, dt, exp(c_L - c), exp(c), log2 dt of the chunk
constexpr int SCR_FLOATS = 5 * L;
// the chunk block's shared vectors: the column sums of (W o G)^T by warp
// (4 L), its row sums (L), q_i (L), x . du (L), r (L), <dS', S> by warp
// (4)
constexpr int VEC_FLOATS = 8 * L + 4;

struct HbMaps {
  CUtensorMap x, b, c, dy;
};

// x, B, C and dy ((b, s, h, 64) / (b, s, g, N) bf16) reach the kernels
// only through their TMA maps (HbMaps)
struct HbArgs {
  const float* dt;                 // (b, s, h) dense
  const float* A;
  const float* states;             // (b, h, G, N, P) forward group states
  float* cstates;                  // (b, h, nc, N, P) chunk incoming states
  float* dstates;                  // (b, h, G, N, P) group state gradients
  float* gdecay;                   // (b, h, G)
  float* dsloc;                    // (b, h, nc, N, P) local dS'
  float* facs;                     // (b, h, nc) decay after the chunk
  void* dx;                        // (b, s, h, 64) dense, bf16 or f32
  float* ddt;
  float* dBp;                      // (b, s, g nsplit, N)
  float* dCp;
  float* dAp;                      // (b, h, nc)
  int b, s, h, g, G, nc, nsplit, hpg;
};

// launch 1's shared memory: WALK_STAGES stages of M's 64-column chunks and
// Y, each warp's scratch, the barriers
template <int N>
struct WalkLayout {
  static constexpr int NC = N / 64;
  static constexpr int STAGE = (NC + 1) * TILE_BYTES;
  static constexpr int SCRATCH = WALK_STAGES * STAGE;
  static constexpr int BARS = SCRATCH + 4 * SCR_FLOATS * 4;
  static constexpr int SMEM = BARS + WALK_STAGES * 8 + 1024;   // 1024 to align
  static_assert(SMEM <= SMEM_OPTIN_BYTES, "ssd bwd walk: shared memory");
};

// launch 3's: B's and C's chunks, sb_stages(N) stages of (x, dy), the three
// parts of dS' (N rows of 64 columns each), the float32 dB and dC sums
// (L, N), the shared vectors, each warp's scratch, the barriers
template <int N>
struct ChunkLayout {
  static constexpr int NC = N / 64;
  static constexpr int RING = 2 * NC * TILE_BYTES;
  static constexpr int STAGE = 2 * TILE_BYTES;
  static constexpr int SPLIT = RING + sb_stages(N) * STAGE;
  static constexpr int PART = NC * TILE_BYTES;
  static constexpr int SUMS = SPLIT + 3 * PART;
  static constexpr int VEC = SUMS + 2 * L * N * 4;
  static constexpr int SCRATCH = VEC + VEC_FLOATS * 4;
  static constexpr int BARS = SCRATCH + 4 * SCR_FLOATS * 4;
  // (SB_BLOCKS_N64 = 1: padded so that one block takes an SM at n 64)
  static constexpr int SMEM = BARS + (1 + sb_stages(N)) * 8 + 1024
                              + (N == 64 && SB_BLOCKS_N64 == 1 ? 120 << 10
                                                               : 0);
  static_assert(SMEM <= SMEM_OPTIN_BYTES, "ssd bwd chunk: shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_sync() {          // the consumer warpgroup
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// ---- mbarriers and TMA (csrc/ssd_scan.cu's, repeated: each source builds
// alone) ----------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
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
// ask the L2 for `bytes` (a multiple of 16) at p
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(__cvta_generic_to_global(p)), "r"(bytes) : "memory");
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
// fragment) . b (16 x 64), b K-major or (TB) MN-major in shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float d[32], const uint32_t a[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TB));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>                    // at most N groups of products in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
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
// the three parts' fragments of one split operand: [part][k-step][4]
__device__ __forceinline__ void fence_split(uint32_t (*a)[4][4]) {
#pragma unroll
  for (int part = 0; part < 3; ++part) fence_frags<4>(a[part]);
}

// 2^x (ex2.approx, relative error ~2^-22; results below 2^-126 flush to 0)
// and log2 x (lg2.approx, absolute error ~2^-22; log2 0 = -inf)
__device__ __forceinline__ float hb_exp2(float x) {
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
  return hb_exp2(x * LOG2E);
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

// A warpgroup's 64 x 64 float32 accumulator as each thread holds it: rows
// 16 w + g + 8 r, columns 8 k + 2 t4 + u at element 4 k + 2 r + u.

// the split register-A fragments [part][k-step] of an accumulator-layout
// 64 x 64 float32 operand (its rows the product's M, its columns its K)
__device__ __forceinline__ void acc_frags(const float v[32],
                                          uint32_t (*fa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 2 * kk + (r >> 1), row = r & 1;
      split_pair(v[4 * k + 2 * row], v[4 * k + 2 * row + 1], fa[0][kk][r],
                 fa[1][kk][r], fa[2][kk][r]);
    }
}

// the chunk's dA = dt A and its inclusive cumsum by a warp scan (two rows a
// lane), into this warp's scratch: c, dt, exp(c_L - c), exp(c), log2 dt;
// returns c_L
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
  const float cs[2] = {c0, c1};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = 2 * lane + e;
    scr[j] = cs[e];
    scr[L + j] = dtr[e];
    scr[2 * L + j] = hb_exp(last - cs[e]);
    scr[3 * L + j] = hb_exp(cs[e]);
    scr[4 * L + j] = hb_log2(dtr[e]);
  }
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

// the split register-A fragments of (M v)^T, rows n of m-block q (64 q +
// 16 w ..), k-step kk (j = 16 kk ..): M^T by ldmatrix.trans from the
// swizzled M tile, scaled by v_j and split
__device__ __forceinline__ void hb_mv(const unsigned char* mt,
                                      const float* v, int q, int kk, int w,
                                      int lane, uint32_t (*bd)[4]) {
  const int j = 16 * kk + (lane & 7) + 8 * (lane >> 4);
  const int pc = 2 * w + ((lane >> 3) & 1);
  uint32_t af[4];
  ldmatrix_x4_trans(af, mt + q * TILE_BYTES + j * 128
                            + ((pc ^ (j & 7)) << 4));
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int jj = 16 * kk + 2 * (lane & 3) + 8 * (r >> 1);
    const float u = __uint_as_float(af[r] << 16) * v[jj];
    const float w2 = __uint_as_float(af[r] & 0xffff0000u) * v[jj + 1];
    split_pair(u, w2, bd[0][r], bd[1][r], bd[2][r]);
  }
}

// X += (M v)^T Y over the chunk, k-step by k-step, each k-step's
// fragments built while the one before runs, waited for at the end (X
// scaled and fenced by the caller before)
template <int NC>
__device__ __forceinline__ void hb_walk_update(float (*X)[32],
                                               const unsigned char* mt,
                                               const unsigned char* yt,
                                               const float* v, int w,
                                               int lane) {
  uint32_t bd[2][3][4];
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int cur = (4 * q + kk) & 1;
      hb_mv(mt, v, q, kk, w, lane, bd[cur]);
      wgmma_fence();
#pragma unroll
      for (int part = 2; part >= 0; --part)
        wgmma_rs<1>(X[q], bd[cur][part], mn_desc(yt + kk * 16 * 128), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (4 * q + kk > 0) fence_frags<3>(bd[cur ^ 1]);
    }
  wgmma_wait<0>();
  fence_frags<3>(bd[(4 * NC - 1) & 1]);
#pragma unroll
  for (int q = 0; q < NC; ++q) fence_acc(X[q]);
}

// X rows n (64 q + 16 w + g, + 8), columns p (8 k + 2 t4, + 1) of a (N, P)
// f32 slab: read (zero from a null slab) or written
template <int NC, bool WRITE>
__device__ __forceinline__ void hb_state_io(float* slab, float (*X)[32],
                                            int w, int g, int t4) {
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* at = reinterpret_cast<float2*>(
            slab + (64 * q + 16 * w + g + 8 * r) * P + 8 * k + 2 * t4);
        if constexpr (WRITE) {
          *at = make_float2(X[q][4 * k + 2 * r], X[q][4 * k + 2 * r + 1]);
        } else {
          const float2 v = slab != nullptr ? *at : make_float2(0.f, 0.f);
          X[q][4 * k + 2 * r] = v.x;
          X[q][4 * k + 2 * r + 1] = v.y;
        }
      }
}
// m-block q of a slab, read (zero from a null slab)
__device__ __forceinline__ void hb_slab_q(const float* slab, float v[32],
                                          int q, int w, int g, int t4) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 x = slab != nullptr
          ? *reinterpret_cast<const float2*>(
                slab + (64 * q + 16 * w + g + 8 * r) * P + 8 * k + 2 * t4)
          : make_float2(0.f, 0.f);
      v[4 * k + 2 * r] = x.x;
      v[4 * k + 2 * r + 1] = x.y;
    }
}

// m-block q of an (N, P) operand's three parts into the split tiles: (n,
// p) at row n, 128-byte swizzled, part after part NC tiles apart, by
// stmatrix: the warp's 16 rows x 8 n-tiles are 16 8 x 8 matrices, four a
// stmatrix (n-tiles 2 m, 2 m + 1, both row halves)
template <int NC>
__device__ __forceinline__ void hb_store_split(unsigned char* ss,
                                               const float v[32], int q,
                                               int w, int lane) {
  constexpr int PART = NC * TILE_BYTES;
  const int rr = lane & 7, half = (lane >> 3) & 1, odd = lane >> 4;
  const int n = 64 * q + 16 * w + 8 * half + rr;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint32_t part[4][3];             // matrices (tile 2 m, 2 m + 1) x halves
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int e = 4 * (2 * m + (f >> 1)) + 2 * (f & 1);
      split_pair(v[e], v[e + 1], part[f][0], part[f][1], part[f][2]);
    }
    unsigned char* at = ss + n * 128 + (((2 * m + odd) ^ rr) << 4);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      stmatrix_x4(at + p * PART, part[0][p], part[1][p], part[2][p],
                  part[3][p]);
  }
}

// the bf16 at (row, column) of a swizzled 64-column tile, as float
__device__ __forceinline__ float tile_at(const unsigned char* t, int row,
                                         int col) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(
      t + row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2);
  return __uint_as_float(uint32_t(v) << 16);
}
// the bf16 pair at (row, column 2 c) of a swizzled 64-column tile
__device__ __forceinline__ float2 tile_pair(const unsigned char* t, int row,
                                            int col) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(
      t + row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2);
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ unsigned char* hb_base(float4* smem4) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
}

// launch 1's copies of walked chunk c (M's chunks, then Y) into the stage
// at d, reported to `full`, by thread 0 (TMA)
template <int N>
__device__ __forceinline__ void walk_issue(const HbMaps& maps,
                                           unsigned char* d, uint64_t* full,
                                           bool rev, int hh, int gg, int bb,
                                           int c) {
  constexpr int NC = N / 64;
  if (threadIdx.x != 0) return;
  mbar_expect(full, (NC + 1) * TILE_BYTES);
#pragma unroll
  for (int q = 0; q < NC; ++q)
    tma_load(d + q * TILE_BYTES, rev ? &maps.c : &maps.b, full, 64 * q, gg,
             c * L, bb);
  tma_load(d + NC * TILE_BYTES, rev ? &maps.dy : &maps.x, full, 0, hh, c * L,
           bb);
}

// ---------------------------------------------------------------------------
// launch 1 (bf16): the walks
// ---------------------------------------------------------------------------

// Blocks x < G: the chunk states (forward from the group state); x >= G:
// the local dS' of each chunk and the decay after it (reverse from zero),
// then the group's own state gradient and decay.
template <int N>
__global__ void __launch_bounds__(HB_THREADS, 1)
    ssd_bwd_walk_hb(const __grid_constant__ HbMaps maps, HbArgs a) {
  constexpr int NC = N / 64;
  using Lt = WalkLayout<N>;
  extern __shared__ float4 smem4[];
  unsigned char* sm = hb_base(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lt::BARS);
  const bool rev = blockIdx.x >= a.G;
  const int grp = rev ? blockIdx.x - a.G : blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z, gg = hh / a.hpg;
  const size_t bh = size_t(bb) * a.h + hh;
  const int c0 = grp * GROUP, c1 = min(a.nc, c0 + GROUP), n = c1 - c0;
  // updates: forward all chunks but the last; reverse all, but the first
  // chunk's only when a group before needs the own gradient
  const int nupd = rev && grp > 0 ? n : n - 1;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < WALK_STAGES; ++st)
      mbar_init(full + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float* scr = reinterpret_cast<float*>(sm + Lt::SCRATCH) + w * SCR_FLOATS;
  const float A = a.A[hh];
  float X[NC][32];
  hb_state_io<NC, false>(
      !rev && a.G > 1 ? const_cast<float*>(a.states) + (bh * a.G + grp) * N * P
                      : nullptr,
      X, w, g, t4);
  float fac = 1.f;                 // the product of the decays walked so far
  float dtr[2] = {0.f, 0.f};
  auto chunk = [&](int k) { return rev ? c1 - 1 - k : c0 + k; };
  if (nupd > 0) {
    walk_issue<N>(maps, sm, full, rev, hh, gg, bb, chunk(0));
    hb_load_dt(dtr, a, bb, hh, chunk(0) * L, lane);
  }
  for (int k = 0; k < n; ++k) {
    const int c = chunk(k);
    // the chunk's slabs; SB_SKIP_SLABS: not those launch 3 takes elsewhere
    // (a group's first state when the forward kept it, the last chunk's
    // zero gradient)
    if (!SB_SKIP_SLABS || k > 0 || (!rev && a.G == 1)) {
      hb_state_io<NC, true>((rev ? a.dsloc : a.cstates)
                                + (bh * a.nc + c) * N * P, X, w, g, t4);
      if (rev && threadIdx.x == 0) a.facs[bh * a.nc + c] = fac;
    }
    if (k >= nupd) break;
    const float last = hb_scan(dtr, A, scr, lane);
    if (k + 1 < nupd) {
      // the next chunk's tiles into the other stage (its last reader, the
      // update of chunk k - 1, is done: the barrier below)
      const int nx = (k + 1) % WALK_STAGES;
      walk_issue<N>(maps, sm + nx * Lt::STAGE, full + nx, rev, hh, gg, bb,
                    chunk(k + 1));
      hb_load_dt(dtr, a, bb, hh, chunk(k + 1) * L, lane);
    }
    const float e_last = hb_exp(last);
    fac *= e_last;
    const int st = k % WALK_STAGES;
    mbar_wait(full + st, (k / WALK_STAGES) & 1);
    const unsigned char* stage = sm + st * Lt::STAGE;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
#pragma unroll
      for (int j = 0; j < 32; ++j) X[q][j] *= e_last;
      fence_acc(X[q]);
    }
    // forward v = exp(c_L - c) dt, reverse v = exp(c)
    float* v = scr + (rev ? 3 * L : 2 * L);
    if (!rev) {
      v[2 * lane] *= scr[L + 2 * lane];
      v[2 * lane + 1] *= scr[L + 2 * lane + 1];
      __syncwarp();
    }
    hb_walk_update<NC>(X, stage, stage + NC * TILE_BYTES, v, w, lane);
    __syncthreads();               // every warp's update has read the stage
  }
  if (rev && grp > 0) {
    hb_state_io<NC, true>(a.dstates + (bh * a.G + grp) * N * P, X, w, g, t4);
    if (threadIdx.x == 0) a.gdecay[bh * a.G + grp] = fac;
  }
}

// ---------------------------------------------------------------------------
// launch 3 (bf16): one chunk, up to HEADS heads of one B/C group
// ---------------------------------------------------------------------------

// the float32 slabs of head bh at chunk c: S, the local dS' (null past the
// group's last chunk), the group's outgoing gradient (null for one group)
struct Slabs {
  const float *S, *loc, *out;
};
template <int N>
__device__ __forceinline__ Slabs hb_slabs(const HbArgs& a, size_t bh, int c,
                                          int c0, int c1, int grp) {
  const size_t slot = (bh * a.nc + c) * size_t(N) * P;
  const size_t gslot = (bh * a.G + grp) * size_t(N) * P;
  Slabs sl;
  sl.S = SB_SKIP_SLABS && c == c0 && a.G > 1 ? a.states + gslot
                                             : a.cstates + slot;
  sl.loc = SB_SKIP_SLABS && c == c1 - 1 ? nullptr : a.dsloc + slot;
  sl.out = a.G > 1 ? a.dstates + gslot : nullptr;
  return sl;
}

// launch 3's copies, by thread 0 (TMA): B's and C's chunks once (`bc`)
template <int N>
__device__ __forceinline__ void chunk_issue_bc(const HbMaps& maps,
                                               unsigned char* sm,
                                               uint64_t* bc, int gg, int bb,
                                               int t0) {
  constexpr int NC = N / 64;
  if (threadIdx.x != 0) return;
  mbar_expect(bc, 2 * NC * TILE_BYTES);
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    tma_load(sm + q * TILE_BYTES, &maps.b, bc, 64 * q, gg, t0, bb);
    tma_load(sm + (NC + q) * TILE_BYTES, &maps.c, bc, 64 * q, gg, t0, bb);
  }
}
// head hd's x and dy into the stage at d (`full`), and (SB_PREFETCH) its
// float32 slabs asked of the L2
template <int N>
__device__ __forceinline__ void chunk_issue_head(const HbMaps& maps,
                                                 const HbArgs& a,
                                                 unsigned char* d,
                                                 uint64_t* full, int hd,
                                                 int bb, int c, int c0,
                                                 int c1, int grp) {
  const int t0 = c * L;
  if (threadIdx.x != 0) return;
  mbar_expect(full, 2 * TILE_BYTES);
  tma_load(d, &maps.x, full, 0, hd, t0, bb);
  tma_load(d + TILE_BYTES, &maps.dy, full, 0, hd, t0, bb);
  if constexpr (SB_PREFETCH) {
    const Slabs sl = hb_slabs<N>(a, size_t(bb) * a.h + hd, c, c0, c1, grp);
    constexpr uint32_t BYTES = N * P * 4;
    prefetch_l2(sl.S, BYTES);
    if (sl.loc != nullptr) prefetch_l2(sl.loc, BYTES);
    if (sl.out != nullptr) prefetch_l2(sl.out, BYTES);
  }
}

// m-block q of S (sv) and of dS' = local + fac x the group's outgoing
// gradient (dv): BRANCHLESS, the three slabs' loads issued at once, with
// no branch between them (a null slab reads S's and counts 0); else slab
// after slab, a null one skipped
template <bool BRANCHLESS>
__device__ __forceinline__ void hb_dsp(const Slabs& sl, float fac,
                                       float sv[32], float dv[32], int q,
                                       int w, int g, int t4) {
  if constexpr (!BRANCHLESS) {
    hb_slab_q(sl.S, sv, q, w, g, t4);
    hb_slab_q(sl.loc, dv, q, w, g, t4);
    if (sl.out != nullptr) {
      float ov[32];
      hb_slab_q(sl.out, ov, q, w, g, t4);
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[i] = dv[i] + fac * ov[i];
    }
    return;
  }
  const float* lp = sl.loc != nullptr ? sl.loc : sl.S;
  const float* op = sl.out != nullptr ? sl.out : sl.S;
  const float lm = sl.loc != nullptr ? 1.f : 0.f;
  const float om = sl.out != nullptr ? fac : 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (64 * q + 16 * w + g + 8 * r) * P + 8 * k + 2 * t4;
      const float2 s2 = *reinterpret_cast<const float2*>(sl.S + off);
      const float2 l2 = *reinterpret_cast<const float2*>(lp + off);
      const float2 o2 = *reinterpret_cast<const float2*>(op + off);
      sv[4 * k + 2 * r] = s2.x;
      sv[4 * k + 2 * r + 1] = s2.y;
      dv[4 * k + 2 * r] = lm * l2.x + om * o2.x;
      dv[4 * k + 2 * r + 1] = lm * l2.y + om * o2.y;
    }
}

// B C^T and x dy^T with rows j (launch 3's (B)), issued
template <int N>
__device__ __forceinline__ void hb_bc_gx(float wt[32], float gt[32],
                                         const unsigned char* bt,
                                         const unsigned char* ct,
                                         const unsigned char* xt,
                                         const unsigned char* yt) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
    wgmma_ss<0>(wt, sw128_desc(bt + off), sw128_desc(ct + off), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(gt, sw128_desc(xt + kk * 32), sw128_desc(yt + kk * 32),
                kk > 0);
}

// the float32 sums (L, N) of a chunk block: element (row, col) at row N +
// (col ^ 8 (row % 8)), so the 8 rows of a fragment's column pair fall in
// distinct banks; 4 columns from a multiple of 4 stay side by side
template <int N>
__device__ __forceinline__ int sum_at(int row, int col) {
  return row * N + (col ^ ((row & 7) << 3));
}

// DXF32: dx in float32, a part of a sum over n-blocks that rounds once.
template <int N, bool DXF32>
__global__ void __launch_bounds__(HB_THREADS, N == 64 ? SB_BLOCKS_N64 : 1)
    ssd_bwd_chunk_hb(const __grid_constant__ HbMaps maps, HbArgs a) {
  constexpr int NC = N / 64;
  using Lt = ChunkLayout<N>;
  constexpr int STAGES = sb_stages(N);
  extern __shared__ float4 smem4[];
  unsigned char* sm = hb_base(smem4);
  uint64_t* bc = reinterpret_cast<uint64_t*>(sm + Lt::BARS);
  uint64_t* full = bc + 1;
  const int c = blockIdx.x, bb = blockIdx.z;
  const int gg = blockIdx.y / a.nsplit, sp = blockIdx.y % a.nsplit;
  const int h0 = gg * a.hpg + sp * HEADS, nh = min(HEADS, a.hpg - sp * HEADS);
  const int grp = c / GROUP, t0 = c * L;
  const int c0 = grp * GROUP, c1 = min(a.nc, c0 + GROUP);
  if (threadIdx.x == 0) {
    mbar_init(bc, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st)
      mbar_init(full + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  chunk_issue_bc<N>(maps, sm, bc, gg, bb, t0);
  chunk_issue_head<N>(maps, a, sm + Lt::RING, full, h0, bb, c, c0, c1, grp);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const unsigned char* bt = sm;                       // B's chunks
  const unsigned char* ct = sm + NC * TILE_BYTES;     // C's chunks
  unsigned char* d3 = sm + Lt::SPLIT;                 // dS' parts
  float* dBs = reinterpret_cast<float*>(sm + Lt::SUMS);   // (L, N)
  float* dCs = dBs + L * N;                                // (L, N)
  float* vec = reinterpret_cast<float*>(sm + Lt::VEC);
  float* rMp = vec;                // (4, L) column sums of (W o G)^T by warp
  float* cM = rMp + 4 * L;         // (L) row sums of (W o G)^T
  float* qv = cM + L;              // (L) q_i
  float* xdv = qv + L;             // (L) x . du
  float* rr = xdv + L;             // (L) r_j
  float* red = rr + L;             // (4) <dS', S> by warp
  float* scr = reinterpret_cast<float*>(sm + Lt::SCRATCH) + w * SCR_FLOATS;
  const float* cs = scr;
  const float* dts = scr + L;
  const float* dec = scr + 2 * L;
  const float* eca = scr + 3 * L;
  const float* l2dt = scr + 4 * L;

  for (int idx = threadIdx.x; idx < 2 * L * N / 4; idx += 128)
    reinterpret_cast<float4*>(dBs)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  wg_sync();
  mbar_wait(bc, 0);
  float dtr[2];
  hb_load_dt(dtr, a, bb, h0, t0, lane);

  for (int k = 0; k < nh; ++k) {
    if (STAGES > 1 && k + 1 < nh) {
      // the next head's tiles into the other stage (its last reader, head
      // k - 1, is done: the barrier at its end)
      const int nx = (k + 1) % STAGES;
      chunk_issue_head<N>(maps, a, sm + Lt::RING + nx * Lt::STAGE, full + nx,
                          h0 + k + 1, bb, c, c0, c1, grp);
    }
    const int hh = h0 + k;
    const size_t bh = size_t(bb) * a.h + hh;
    const float A = a.A[hh];
    const float last = hb_scan(dtr, A, scr, lane);
    if (k + 1 < nh) hb_load_dt(dtr, a, bb, hh + 1, t0, lane);
    const int st = k % STAGES;
    mbar_wait(full + st, (k / STAGES) & 1);
    const unsigned char* xt = sm + Lt::RING + st * Lt::STAGE;
    const unsigned char* yt = xt + TILE_BYTES;
    const Slabs sl = hb_slabs<N>(a, bh, c, c0, c1, grp);

    // (A) S split into the tiles; dC = exp(c_i) dy S^T (rows i, kept in the
    // accumulators through (C)) and q_i, dy x^T beside it
    const float fac = sl.loc != nullptr ? a.facs[bh * a.nc + c] : 1.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      float sv[32];
      hb_slab_q(sl.S, sv, q, w, g, t4);
      hb_store_split<NC>(d3, sv, q, w, lane);
    }
    fence_proxy_async();           // S's tiles, for wgmma
    wg_sync();
    float dc[NC][32], ge[32];
#pragma unroll
    for (int q = 0; q < NC; ++q) fence_acc(dc[q]);
    fence_acc(ge);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < NC; ++q)
#pragma unroll
      for (int part = 2; part >= 0; --part)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(dc[q], sw128_desc(yt + kk * 32),
                      sw128_desc(d3 + part * Lt::PART + q * TILE_BYTES
                                 + kk * 32),
                      part < 2 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0>(ge, sw128_desc(yt + kk * 32), sw128_desc(xt + kk * 32),
                  kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < NC; ++q) fence_acc(dc[q]);
    fence_acc(ge);
    {
      // rows i = 16 w + g + 8 r, columns n = 64 q + 8 k + 2 t4 + u
      float qa[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < NC; ++q)
#pragma unroll
        for (int kq = 0; kq < 8; ++kq)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 16 * w + g + 8 * r, e = 4 * kq + 2 * r;
            const float ei = eca[i];
            dc[q][e] *= ei;
            dc[q][e + 1] *= ei;
            const float2 cv = tile_pair(ct + q * TILE_BYTES, i,
                                        8 * kq + 2 * t4);
            qa[r] += cv.x * dc[q][e] + cv.y * dc[q][e + 1];
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = qa[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t4 == 0) qv[16 * w + g + 8 * r] = v;
      }
    }

    // (C) G o E (rows i; dt_j folded into the exponent), split; dC +=
    // (G o E) B on top of (A)'s
    float wt[32], gt[32];
    {
#pragma unroll
      for (int kq = 0; kq < 8; ++kq)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 4 * kq + 2 * r + u;
            const int i = 16 * w + g + 8 * r, j = 8 * kq + 2 * t4 + u;
            float x;
            if constexpr (SB_FOLD)
              x = ge[e] * hb_exp2(__fmaf_rn(cs[i] - cs[j], LOG2E, l2dt[j]));
            else
              x = ge[e] * hb_exp2((cs[i] - cs[j]) * LOG2E) * dts[j];
            ge[e] = j <= i ? x : 0.f;
          }
      uint32_t ga[3][4][4];
      acc_frags(ge, ga);
#pragma unroll
      for (int q = 0; q < NC; ++q) fence_acc(dc[q]);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < NC; ++q)
#pragma unroll
        for (int part = 2; part >= 0; --part)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<1>(dc[q], ga[part][kk],
                        mn_desc(bt + q * TILE_BYTES + kk * 16 * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_split(ga);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        fence_acc(dc[q]);
#pragma unroll
        for (int kq = 0; kq < 8; ++kq)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2* at = reinterpret_cast<float2*>(
                dCs + sum_at<N>(16 * w + g + 8 * r, 64 * q + 8 * kq + 2 * t4));
            const float2 o = *at;
            *at = make_float2(o.x + dc[q][4 * kq + 2 * r],
                              o.y + dc[q][4 * kq + 2 * r + 1]);
          }
      }
    }
    {
      // dS' = local + decay x the group's outgoing gradient split into the
      // tiles (dy S^T has read S's); <dS', S>; B C^T and x dy^T issued
      wg_sync();
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        float sv[32], dv[32];
        hb_dsp<sb_branchless(N)>(sl, fac, sv, dv, q, w, g, t4);
#pragma unroll
        for (int i = 0; i < 32; ++i) dot += dv[i] * sv[i];
        hb_store_split<NC>(d3, dv, q, w, lane);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) red[w] = dot;
      fence_proxy_async();         // the dS' tiles, for wgmma
      fence_acc(wt);
      fence_acc(gt);
      wgmma_fence();
      hb_bc_gx<N>(wt, gt, bt, ct, xt, yt);
      wgmma_commit();
    }
    wgmma_wait<0>();               // B C^T and x dy^T
    fence_acc(wt);
    fence_acc(gt);
    wg_sync();                     // the dS' tiles are complete

    // (B) rows j: W^T, (G o E)^T; du, dx, x . du, r; dB += (G o E)^T C +
    // exp(c_L - c_j) dt_j (x dS'^T)
    {
      // rows j = 16 w + g + 8 r, columns i = 8 k + 2 t4 + u: W^T_ji =
      // (C B^T)_ij E_ij, (G o E)^T_ji = (x_j . dy_i) dt_j E_ij, and (W o
      // G)^T_ji = (C B^T)_ij (G o E)_ij
      float rowm[2] = {0.f, 0.f}, colm[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) colm[i] = 0.f;
#pragma unroll
      for (int kq = 0; kq < 8; ++kq)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 4 * kq + 2 * r + u;
            const int j = 16 * w + g + 8 * r, i = 8 * kq + 2 * t4 + u;
            const float ee = hb_exp2((cs[i] - cs[j]) * LOG2E);
            const float gv = gt[e] * dts[j] * (i >= j ? ee : 0.f);
            const float m = wt[e] * gv;
            wt[e] = i >= j ? wt[e] * ee : 0.f;
            gt[e] = gv;
            rowm[r] += m;
            colm[2 * kq + u] += m;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = rowm[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t4 == 0) cM[16 * w + g + 8 * r] = v;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float v = colm[i];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) rMp[w * L + 8 * (i >> 1) + 2 * t4 + (i & 1)] = v;
      }
      // du = W^T dy (W^T split, register-A; dy MN-major) and B dS' (B
      // K-major; dS' MN-major)
      float du[32], dus[32];
      {
        uint32_t wa[3][4][4];
        acc_frags(wt, wa);
        fence_acc(du);
        fence_acc(dus);
        wgmma_fence();
#pragma unroll
        for (int part = 2; part >= 0; --part)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<1>(du, wa[part][kk], mn_desc(yt + kk * 16 * 128),
                        part < 2 || kk > 0);
#pragma unroll
        for (int part = 2; part >= 0; --part)
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk)
            wgmma_ss<1>(dus,
                        sw128_desc(bt + (kk >> 2) * TILE_BYTES
                                   + (kk & 3) * 32),
                        mn_desc(d3 + part * Lt::PART + kk * 16 * 128),
                        part < 2 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_split(wa);
        fence_acc(du);
        fence_acc(dus);
      }
      // rows j, columns p = 8 k + 2 t4 + u: dx = dt_j (du + dec_j dus)
      {
        float xd[2] = {0.f, 0.f}, xr[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 16 * w + g + 8 * r, t = t0 + j;
          const float dj = dec[j], tj = dts[j];
          const size_t row = ((size_t(bb) * a.s + t) * a.h + hh) * P;
#pragma unroll
          for (int kq = 0; kq < 8; ++kq) {
            const int e = 4 * kq + 2 * r, p = 8 * kq + 2 * t4;
            const float2 xv = tile_pair(xt, j, p);
            const float s0 = dj * dus[e], s1 = dj * dus[e + 1];
            const float d0 = du[e] + s0, d1 = du[e + 1] + s1;
            xd[r] += xv.x * d0 + xv.y * d1;
            xr[r] += xv.x * dus[e] + xv.y * dus[e + 1];
            if (t < a.s) {
              if constexpr (DXF32)
                *reinterpret_cast<float2*>(static_cast<float*>(a.dx) + row
                                           + p) = make_float2(d0 * tj,
                                                              d1 * tj);
              else
                *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dx)
                                                   + row + p) =
                    __floats2bfloat162_rn(d0 * tj, d1 * tj);
            }
          }
          float v = xd[r], u = xr[r];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          u += __shfl_xor_sync(0xffffffffu, u, 1);
          u += __shfl_xor_sync(0xffffffffu, u, 2);
          if (t4 == 0) {
            xdv[j] = v;
            rr[j] = u * dj * tj;
          }
        }
      }
      // dB, per 64-column chunk q of n: (G o E)^T C (split, register-A; C
      // MN-major) and x dS'^T (x K-major; dS' K-major)
      uint32_t ga[3][4][4];
      acc_frags(gt, ga);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        float bg[32], bs[32];
        fence_acc(bg);
        fence_acc(bs);
        wgmma_fence();
#pragma unroll
        for (int part = 2; part >= 0; --part)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<1>(bg, ga[part][kk],
                        mn_desc(ct + q * TILE_BYTES + kk * 16 * 128),
                        part < 2 || kk > 0);
#pragma unroll
        for (int part = 2; part >= 0; --part)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<0>(bs, sw128_desc(xt + kk * 32),
                        sw128_desc(d3 + part * Lt::PART + q * TILE_BYTES
                                   + kk * 32),
                        part < 2 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_split(ga);
        fence_acc(bg);
        fence_acc(bs);
#pragma unroll
        for (int kq = 0; kq < 8; ++kq)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = 16 * w + g + 8 * r, e = 4 * kq + 2 * r;
            const float f = dec[j] * dts[j];
            float2* at = reinterpret_cast<float2*>(
                dBs + sum_at<N>(j, 64 * q + 8 * kq + 2 * t4));
            const float2 o = *at;
            *at = make_float2(o.x + (bg[e] + f * bs[e]),
                              o.y + (bg[e + 1] + f * bs[e + 1]));
          }
      }
    }
    wg_sync();                     // the vectors are complete

    // warp 0: dc, da = its reverse cumsum, ddt, this head's dA part
    if (w == 0) {
      float dA_acc = 0.f;
      const int i0 = 2 * lane, i1 = i0 + 1;
      float rsum = rr[i0] + rr[i1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      const float dS = red[0] + red[1] + red[2] + red[3];
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + e;
        const float rowM = rMp[i] + rMp[L + i] + rMp[2 * L + i]
                           + rMp[3 * L + i];
        d[e] = rowM - cM[i] + qv[i] - rr[i];
      }
      if (i1 == L - 1) d[1] += hb_exp(last) * dS + rsum;
      float run = d[0] + d[1];     // suffix sums over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, run, o);
        if (lane + o < 32) run += v;
      }
      const float das[2] = {run, run - d[0]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + e, t = t0 + i;
        if (t < a.s)
          a.ddt[(size_t(bb) * a.s + t) * a.h + hh] = xdv[i] + A * das[e];
        dA_acc += dts[i] * das[e];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dA_acc += __shfl_xor_sync(0xffffffffu, dA_acc, o);
      if (lane == 0) a.dAp[bh * a.nc + c] = dA_acc;
    }
    wg_sync();                     // the vectors and the tiles are free
    if (STAGES == 1 && k + 1 < nh)
      chunk_issue_head<N>(maps, a, sm + Lt::RING, full, h0 + k + 1, bb, c, c0,
                          c1, grp);
  }

  // this block's dB and dC, summed over its heads: one float32 row each
  const int R = a.g * a.nsplit, row = gg * a.nsplit + sp;
  for (int idx = threadIdx.x; idx < L * N / 4; idx += 128) {
    const int r = idx / (N / 4), c4 = idx % (N / 4), t = t0 + r;
    if (t >= a.s) continue;
    const size_t o = ((size_t(bb) * a.s + t) * R + row) * N + 4 * c4;
    const int at = sum_at<N>(r, 4 * c4);
    *reinterpret_cast<float4*>(a.dBp + o) =
        *reinterpret_cast<const float4*>(dBs + at);
    *reinterpret_cast<float4*>(a.dCp + o) =
        *reinterpret_cast<const float4*>(dCs + at);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int N>
int launch_f32(const BwdArgs& a, cudaStream_t s) {
  cudaError_t err;
  err = cudaFuncSetAttribute(ssd_bwd_state_f32<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             state_smem_bytes<N>());
  if (err != cudaSuccess) return int(err);
  ssd_bwd_state_f32<N><<<dim3(a.G, a.h, a.b), THREADS,
                            state_smem_bytes<N>(), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (a.G > 1) {
    ssd_bwd_pass<N><<<dim3(N * P / PASS_THREADS, a.h, a.b), PASS_THREADS, 0,
                      s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  err = cudaFuncSetAttribute(ssd_bwd_scan_f32<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             scan_smem_bytes<N>());
  if (err != cudaSuccess) return int(err);
  ssd_bwd_scan_f32<N><<<dim3(a.G, a.h, a.b), THREADS, scan_smem_bytes<N>(),
                           s>>>(a);
  return int(cudaGetLastError());
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
int hb_launch(K kernel, int smem, dim3 grid, const HbMaps& maps,
              const HbArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, HB_THREADS, smem, s>>>(maps, a);
  return int(cudaGetLastError());
}

// the walks, the pass (more than one group), the chunk blocks
template <int N, bool DXF32>
int launch_hb(const BwdArgs& pa, const long long st[12], cudaStream_t s) {
  HbMaps maps;
  std::memset(&maps, 0, sizeof maps);
  if (!hb_encode(&maps.x, pa.x, P, pa.h, pa.s, pa.b, st) ||
      !hb_encode(&maps.b, pa.B, N, pa.g, pa.s, pa.b, st + 3) ||
      !hb_encode(&maps.c, pa.C, N, pa.g, pa.s, pa.b, st + 6) ||
      !hb_encode(&maps.dy, pa.dy, P, pa.h, pa.s, pa.b, st + 9))
    return int(cudaErrorInvalidValue);
  HbArgs a;
  std::memset(&a, 0, sizeof a);
  a.dt = pa.dt;
  a.A = pa.A;
  a.states = pa.states;
  a.cstates = pa.cstates;
  a.dstates = pa.dstates;
  a.gdecay = pa.gdecay;
  a.dsloc = pa.dsloc;
  a.facs = pa.facs;
  a.dx = pa.dx;
  a.ddt = pa.ddt;
  a.dBp = pa.dBp;
  a.dCp = pa.dCp;
  a.dAp = pa.dAp;
  a.b = pa.b;
  a.s = pa.s;
  a.h = pa.h;
  a.g = pa.g;
  a.G = pa.G;
  a.nc = pa.nc;
  a.nsplit = pa.nsplit;
  a.hpg = pa.h / pa.g;
  int err = hb_launch(ssd_bwd_walk_hb<N>, WalkLayout<N>::SMEM,
                      dim3(2 * pa.G, pa.h, pa.b), maps, a, s);
  if (err) return err;
  if (pa.G > 1) {
    ssd_bwd_pass<N><<<dim3(N * P / PASS_THREADS, pa.h, pa.b), PASS_THREADS,
                      0, s>>>(pa);
    err = int(cudaGetLastError());
    if (err) return err;
  }
  return hb_launch(ssd_bwd_chunk_hb<N, DXF32>, ChunkLayout<N>::SMEM,
                   dim3(pa.nc, pa.g * pa.nsplit, pa.b), maps, a, s);
}

}  // namespace

// Heads of one B/C group a bf16 chunk block takes (the wrapper's nsplit =
// ceil((h / g) / heads)).
extern "C" int ssd_scan_bwd_heads() { return HEADS; }

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 (x, B, C, dy and dx; dt, A and the rest float32), 2 =
// bfloat16 with a float32 dx (one n-block's part of a sum).
// Supported: chunk 64, p 64, n 64 or 128, group 8.  `strides` after the
// ints: the element strides of x (head, row, batch), of B and of C
// (group, row, batch) and of dy (head, row, batch), the last axis dense;
// float32 takes dense tensors only, bf16 any strides (and bases) on 16
// bytes; dt and dx are dense.  With G = ceil(nc / 8) groups of the nc =
// ceil(s / 64) chunks: `states` (b, h, G, n, p) are the forward's group
// states (null when G = 1); `cstates` (b, h, nc, n, p), `dstates` (b, h,
// G, n, p; null when G = 1) and `gdecay` (b, h, G) are float32 scratch,
// and so are, for bf16 only, `dsloc` (b, h, nc, n, p) and `facs` (b, h,
// nc) (null for float32).  Outputs: dx (b, s, h, p), ddt (b, s, h), and
// float32 dBp / dCp and dAp: for float32 per head, (b, s, h, n) and (b, h,
// G); for bf16 (b, s, g * nsplit, n), each row the sum over its block's
// heads, nsplit = ceil((h / g) / ssd_scan_bwd_heads()), and (b, h, nc).
// Launches three kernels (two when G = 1) on `stream`, does not
// synchronise, allocates nothing; returns a CUDA error code (0 =
// success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* dy, const float* states, float* cstates,
    float* dstates, float* gdecay, float* dsloc, float* facs, void* dx,
    float* ddt, float* dBp, float* dCp, float* dAp, int b, int s, int h,
    int p, int g, int n, int chunk, int group, int dtype, long long xh,
    long long xs, long long xb, long long bg, long long bs, long long bb,
    long long cg, long long cs, long long cb, long long yh, long long ys,
    long long yb, void* stream) {
  if (b < 0 || s < 0 || h < 1 || g < 1 || h % g != 0 || b > 65535 ||
      h > 65535)
    return int(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return 0;
  if (chunk != L || p != P || group != GROUP)
    return int(cudaErrorInvalidValue);
  const int nc = (s + L - 1) / L;
  const int G = (nc + GROUP - 1) / GROUP;
  const int nsplit = (h / g + HEADS - 1) / HEADS;
  if (G > 1 && (states == nullptr || dstates == nullptr))
    return int(cudaErrorInvalidValue);
  if (dtype >= 1 && (dsloc == nullptr || facs == nullptr ||
                     size_t(g) * nsplit > 65535))
    return int(cudaErrorInvalidValue);
  const BwdArgs a{x, dt, A, B, C, dy, G > 1 ? states : nullptr, cstates,
                  dstates, gdecay, dsloc, facs, dx, ddt, dBp, dCp, dAp, b, s,
                  h, g, G, nc, nsplit};
  const long long st[12] = {xh, xs, xb, bg, bs, bb, cg, cs, cb, yh, ys, yb};
  const cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {                // float32: dense inputs only
    const long long hp = (long long)h * P, gn = (long long)g * n;
    const long long dense[12] = {P, hp, s * hp, n, gn, s * gn,
                                 n, gn, s * gn, P, hp, s * hp};
    for (int i = 0; i < 12; ++i)
      if (st[i] != dense[i]) return int(cudaErrorInvalidValue);
    if (n == 64) return launch_f32<64>(a, stream_);
    if (n == 128) return launch_f32<128>(a, stream_);
  }
  if (dtype == 1 && n == 64) return launch_hb<64, false>(a, st, stream_);
  if (dtype == 1 && n == 128) return launch_hb<128, false>(a, st, stream_);
  if (dtype == 2 && n == 64) return launch_hb<64, true>(a, st, stream_);
  if (dtype == 2 && n == 128) return launch_hb<128, true>(a, st, stream_);
  return int(cudaErrorInvalidValue);
}
#endif
