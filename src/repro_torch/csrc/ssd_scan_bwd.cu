// The gradient of the Mamba2 SSD chunked scan for Hopper (sm_90a)
// [arXiv:2405.21060]: given dy, the gradients of x, dt, A, B and C of the
// scan from a zero state; float32 or bfloat16 x/B/C/dy.  Narrower p and n
// arrive zero-padded (dy too) from the wrapper, as in the forward.
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
// bfloat16: three launches (two when one group holds every chunk), every
// product on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out,
// operands by ldmatrix):
//
//   1. ssd_bwd_walk_bf16, grid (2 G, h, b): blocks x < G walk their group's
//      chunks forward from the saved group state and write every chunk's
//      incoming state S (b, h, nc, N, P); blocks x >= G walk the group's
//      chunks in reverse from a zero gradient and write, for each chunk,
//      the part of dS' that the group's own later rows give (b, h, nc, N,
//      P) and the product of the decays of the group's chunks after it
//      (b, h, nc); at the group's first chunk that walk holds the group's
//      own incoming-state gradient and decay, which it writes for the
//      pass.  Each step is X <- exp(c_L) X + M^T (v o Y): (M, v, Y) = (B,
//      exp(c_L - c) dt, x) forward, (C, exp(c), dy) in reverse.  The next
//      chunk's M and Y rows are copied by cp.async while this one computes.
//   2. ssd_bwd_pass, grid (N P / 256, h, b): walks the groups from the last
//      to the first and leaves in each slot the gradient of that group's
//      outgoing state (no launch when G = 1);
//   3. ssd_bwd_chunk_bf16, grid (nc, g * nsplit, b): one chunk and up to
//      HEADS heads of one B/C group.  dS' = local + decay x the group's
//      outgoing gradient; then, head after head, the chunk's gradient, with
//      B and C staged once for the block and each head's x and dy copied by
//      cp.async while the head before finishes.  The block adds its heads'
//      dB and dC in head order in registers and writes one float32 row
//      (b, s, g * nsplit, N) for them: the wrapper sums the nsplit =
//      ceil((h / g) / HEADS) rows of each group.  dA goes out per (batch,
//      head, chunk).
//
// The products (each chunk, each head):
//   C B^T and dy x^T: both operands exact bf16, one mma each, only on the
//     10 of the 16 (16 x 16) sub-tiles on or below the diagonal; dt_j and
//     E are applied in float32 to the accumulators, which hold W and GE
//     for those sub-tiles.  W and GE are split (below) into shared memory,
//     10 sub-tiles each, and the products that read them skip the zero
//     sub-tiles: W^T dy, GE^T C, GE B.
//   B dS'^T, x dS', dy S: dS' and S are split.
//   C^T (exp(c) dy) and B^T (dec dt x) in launch 1: the scaled operand is
//     split.
// A float32 operand v is split into PARTS bf16 parts (v = hi + mid + lo
// with three: every bit of v), each part goes through its own mma (bf16
// products are exact in float32), smallest first; sums are float32.  So
// the error is float32 rounding, as in the forward's bf16 path.
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
// B/C (b, s, g, n); all contiguous, 16-byte aligned.
//
// What bounds it: at zamba2's shape (b = 2, s = 4096, h = 64, p = 64,
// g = 1, n = 64, bf16) the function moves ~209 MB (x, dy, dx, B, C, dB,
// dC, dt, ddt: ~0.062 ms at 3.35 TB/s) and does ~2.5 x the forward's
// ~13 GFLOP of products (~0.033 ms on the bf16 tensor cores), so it is
// bound by bytes.  The bf16 design moves ~0.5 GB of float32 chunk states
// and local gradients through memory beside that (written by launch 1,
// read by launch 3) and runs ~3x the function's products through the
// split; what holds it back is in PERF.md.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;              // chunk length
constexpr int P = 64;              // head dim
constexpr int GROUP = 8;           // chunks per group (the forward's)
constexpr int THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr int HEADS = 8;           // heads of one B/C group a chunk block takes
constexpr int PARTS = 3;           // bf16 parts of a split operand

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
// bfloat16: the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int SB = P + 8;          // row stride of a 64-wide bf16 tile
constexpr int TRI = 10 * 256;      // a part of W or GE: 10 16 x 16 sub-tiles

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
__device__ __forceinline__ void ldsm(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two n-tiles of one A fragment: c0 += a . b[0..1], c1 += a . b[2..3]
__device__ __forceinline__ void mma_pair(float c0[4], float c1[4],
                                         const uint32_t a[4],
                                         const uint32_t b[4]) {
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// The four ldmatrix addressings, as element offsets for this lane in a
// tile of row stride `ld`.  A operand (16 x 16, rows m0.., k0..) stored
// [m][k] (a_mk) or [k][m] (a_km, read transposed); B operand (k0.., two
// n-tiles n0.. and n0 + 8) stored [n][k] (b_nk) or [k][n] (b_kn,
// transposed).
__device__ __forceinline__ int a_mk(int ld, int m0, int k0, int lane) {
  return (m0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4);
}
__device__ __forceinline__ int a_km(int ld, int m0, int k0, int lane) {
  return (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int b_nk(int ld, int n0, int k0, int lane) {
  return (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int b_kn(int ld, int k0, int n0, int lane) {
  return (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 + 8 * (lane >> 4);
}

// W and GE keep only the 10 sub-tiles (it, jt), jt <= it, each 16 x 16
// row-major with its two 16-byte halves swapped on rows 4-7 and 12-15 (no
// bank conflicts for ldmatrix or the fragment stores)
__device__ __forceinline__ int tri_tile(int it, int jt) {
  return (it * (it + 1) / 2 + jt) * 256;
}
__device__ __forceinline__ int tri_off(int r, int c) {
  return r * 16 + ((((c >> 3) ^ (r >> 2)) & 1) << 3) + (c & 7);
}

// v = sum of its PARTS bf16 parts, largest first
__device__ __forceinline__ void split(float v, bf16 part[PARTS]) {
  float r = v;
#pragma unroll
  for (int q = 0; q < PARTS; ++q) {
    part[q] = __float2bfloat16_rn(r);
    r = r - __bfloat162float(part[q]);             // exact
  }
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the PARTS bf16x2 words of the split of (u, v)
__device__ __forceinline__ void split2(float u, float v, uint32_t w[PARTS]) {
  bf16 a[PARTS], b[PARTS];
  split(u, a);
  split(v, b);
#pragma unroll
  for (int q = 0; q < PARTS; ++q) w[q] = pack2(a[q], b[q]);
}
__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Copy rows [t0, t0 + L) of head `hd` of a (b, s, heads, W) bf16 tensor
// into a tile of stride W + 8; rows >= s are zero-filled.
template <int W>
__device__ __forceinline__ void stage(bf16* dst, const void* src_, int bb,
                                      int s, int heads, int hd, int t0) {
  const bf16* src = static_cast<const bf16*>(src_);
  constexpr int CH = W / 8;        // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < L * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH, t = t0 + r;
    const bool in = t < s;
    cp_async16(dst + r * (W + 8) + 8 * c,
               src + ((size_t(bb) * s + (in ? t : 0)) * heads + hd) * W
                   + 8 * c,
               in ? 16 : 0);
  }
}

// launch 1 (bf16): the walks

template <int N>
constexpr int walk_smem_bytes() {
  return 5 * L * 4 + (2 * L * (N + 8) + 2 * L * SB + PARTS * L * SB) * 2;
}

// X[q][nt] (rows 64 q + 16 rt + .., columns 32 half + 8 nt + .. of the
// (N, P) state) = X e_last + M^T Y3: A = M^T by ldmatrix.trans from the
// staged rows of M, B = the parts of v o Y, smallest first
template <int N>
__device__ __forceinline__ void walk_update(float X[][4][4], const bf16* Ms,
                                            const bf16* Y3, float e_last,
                                            int rt, int half, int lane) {
  constexpr int SN = N + 8;
#pragma unroll
  for (int q = 0; q < N / 64; ++q) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) X[q][nt][e] *= e_last;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      uint32_t af[4];
      ldsm_t(af, Ms + a_km(SN, 64 * q + 16 * rt, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np)
#pragma unroll
        for (int part = PARTS - 1; part >= 0; --part) {
          uint32_t yb[4];
          ldsm_t(yb, Y3 + part * L * SB
                         + b_kn(SB, 16 * kk, 32 * half + 16 * np, lane));
          mma_pair(X[q][2 * np], X[q][2 * np + 1], af, yb);
        }
    }
  }
}

template <int N>
__device__ __forceinline__ void store_frags(float* out, const float X[][4][4],
                                            int rt, int half, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int q = 0; q < N / 64; ++q)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            out + (64 * q + 16 * rt + g + 8 * r) * P + 32 * half + 8 * nt
            + 2 * t4) = make_float2(X[q][nt][2 * r], X[q][nt][2 * r + 1]);
}

// Blocks x < G: the chunk states (forward from the group state); x >= G:
// the local dS' of each chunk and the decay after it (reverse from zero),
// then the group's own state gradient and decay.
template <int N>
__global__ void __launch_bounds__(THREADS, 2) ssd_bwd_walk_bf16(BwdArgs a) {
  constexpr int SN = N + 8;
  extern __shared__ float4 smem4[];
  float* dts = reinterpret_cast<float*>(smem4);
  float* cas = dts + L;
  float* eca = cas + L;
  float* dec = eca + L;
  float* vs = dec + L;                            // the scale of Y's rows
  bf16* Ms = reinterpret_cast<bf16*>(vs + L);     // 2 x (L, SN)
  bf16* Ys = Ms + 2 * L * SN;                     // 2 x (L, SB)
  bf16* Y3 = Ys + 2 * L * SB;                     // PARTS x (L, SB)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rt = warp % 4, half = warp / 4;
  const bool rev = blockIdx.x >= a.G;
  const int grp = rev ? blockIdx.x - a.G : blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int gg = hh / (a.h / a.g);
  const float A = a.A[hh];
  const size_t bh = size_t(bb) * a.h + hh;
  const int c0 = grp * GROUP, c1 = min(a.nc, c0 + GROUP), n = c1 - c0;
  const void* Mg = rev ? a.C : a.B;
  const void* Yg = rev ? a.dy : a.x;
  // updates: forward all chunks but the last; reverse all, but the first
  // chunk's only when a group before needs the own gradient
  const int nupd = rev && grp > 0 ? n : n - 1;

  float X[N / 64][4][4];
  const float* st = a.states + (bh * a.G + grp) * N * P;
#pragma unroll
  for (int q = 0; q < N / 64; ++q)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 v = make_float2(0.f, 0.f);
        if (!rev && a.G > 1)
          v = *reinterpret_cast<const float2*>(
              st + (64 * q + 16 * rt + g + 8 * r) * P + 32 * half + 8 * nt
              + 2 * t4);
        X[q][nt][2 * r] = v.x;
        X[q][nt][2 * r + 1] = v.y;
      }
  float fac = 1.f;                 // product of the decays walked so far
  float dtr[2] = {0.f, 0.f};
  auto chunk = [&](int k) { return rev ? c1 - 1 - k : c0 + k; };
  if (nupd > 0) {
    stage<N>(Ms, Mg, bb, a.s, a.g, gg, chunk(0) * L);
    stage<P>(Ys, Yg, bb, a.s, a.h, hh, chunk(0) * L);
    cp_async_commit();
    if (warp == 0) load_dt(dtr, a, bb, hh, chunk(0) * L);
  }

  for (int k = 0; k < n; ++k) {
    const int c = chunk(k);
    store_frags<N>((rev ? a.dsloc : a.cstates) + (bh * a.nc + c) * N * P, X,
                   rt, half, lane);
    if (rev && tid == 0) a.facs[bh * a.nc + c] = fac;
    if (k >= nupd) break;
    const bf16* Mk = Ms + (k & 1) * L * SN;
    const bf16* Yk = Ys + (k & 1) * L * SB;
    if (warp == 0) {
      chunk_cumsum(dtr, A, dts, cas, eca, dec);
      vs[2 * lane] = rev ? eca[2 * lane] : dec[2 * lane] * dts[2 * lane];
      vs[2 * lane + 1] =
          rev ? eca[2 * lane + 1] : dec[2 * lane + 1] * dts[2 * lane + 1];
    }
    if (k + 1 < nupd) {            // the next chunk loads while this computes
      stage<N>(Ms + ((k + 1) & 1) * L * SN, Mg, bb, a.s, a.g, gg,
               chunk(k + 1) * L);
      stage<P>(Ys + ((k + 1) & 1) * L * SB, Yg, bb, a.s, a.h, hh,
               chunk(k + 1) * L);
      cp_async_commit();
      if (warp == 0) load_dt(dtr, a, bb, hh, chunk(k + 1) * L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int idx = tid; idx < L * P / 2; idx += THREADS) {
      const int j = idx / (P / 2), p = 2 * (idx % (P / 2));
      const float2 y = ld_bf2(Yk + j * SB + p);
      uint32_t w[PARTS];
      split2(y.x * vs[j], y.y * vs[j], w);
#pragma unroll
      for (int q = 0; q < PARTS; ++q)
        *reinterpret_cast<uint32_t*>(Y3 + q * L * SB + j * SB + p) = w[q];
    }
    __syncthreads();
    const float e_last = expf(cas[L - 1]);
    walk_update<N>(X, Mk, Y3, e_last, rt, half, lane);
    fac *= e_last;
    __syncthreads();               // Y3, the vectors and this stage are free
  }
  if (rev && grp > 0) {
    store_frags<N>(a.dstates + (bh * a.G + grp) * N * P, X, rt, half, lane);
    if (tid == 0) a.gdecay[bh * a.G + grp] = fac;
  }
}

// launch 3 (bf16): one chunk, up to HEADS heads of one B/C group

constexpr int CH_VEC = 4 * L + 12 * L + 16;   // f32 vectors of a chunk block

// the slab region: the split slabs of S and dS', then W and GE with du
// parked beside them
constexpr int SLAB_BYTES = 2 * PARTS * 64 * SB * 2;
constexpr int WGE_BYTES = 2 * PARTS * TRI * 2;
constexpr int UNION_BYTES = SLAB_BYTES > WGE_BYTES + L * SB * 4
                                ? SLAB_BYTES : WGE_BYTES + L * SB * 4;

template <int N>
constexpr int chunk_smem_bytes() {
  return (CH_VEC + L * (N + 8)) * 4 + (2 * L * (N + 8) + 2 * L * SB) * 2
         + UNION_BYTES;
}

template <int N>
__global__ void __launch_bounds__(THREADS, N == 64 ? 2 : 1)
ssd_bwd_chunk_bf16(BwdArgs a) {
  constexpr int SN = N + 8, NQ = N / 64;
  extern __shared__ float4 smem4[];
  float* dts = reinterpret_cast<float*>(smem4);
  float* cas = dts + L;
  float* eca = cas + L;
  float* dec = eca + L;
  float* rowp = dec + L;           // (2, L) row sums of W o G, by column half
  float* colp = rowp + 2 * L;      // (4, L) column sums, by row tile
  float* qp = colp + 4 * L;        // (2, L) exp(c_i) C_i . S^T dy_i
  float* rp = qp + 2 * L;          // (2, L) r_j
  float* xp = rp + 2 * L;          // (2, L) x_j . du_j
  float* red = xp + 2 * L;         // (2, 8) <dS', S> by warp, two heads
  float* dCs = red + 16;           // (L, SN) dC of the block's heads so far
  bf16* Bs = reinterpret_cast<bf16*>(dCs + L * SN);  // (L, SN)
  bf16* Cs = Bs + L * SN;                        // (L, SN)
  bf16* xs = Cs + L * SN;                        // (L, SB)
  bf16* dys = xs + L * SB;                       // (L, SB)
  bf16* S3 = dys + L * SB;         // PARTS x (64, SB): a 64-row slab of S
  bf16* D3 = S3 + PARTS * 64 * SB; // PARTS x (64, SB): the slab of dS'
  bf16* W3 = S3;                   // PARTS x TRI, once the slabs are read
  bf16* GE3 = W3 + PARTS * TRI;
  float* duS = reinterpret_cast<float*>(GE3 + PARTS * TRI);  // (L, SB) du

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int t = warp % 4, hf = warp / 4;       // 16-row tile, column half
  const int c = blockIdx.x, bb = blockIdx.z;
  const int hpg = a.h / a.g;
  const int gg = blockIdx.y / a.nsplit, sp = blockIdx.y % a.nsplit;
  const int h0 = gg * hpg + sp * HEADS, nh = min(HEADS, hpg - sp * HEADS);
  const int grp = c / GROUP, t0 = c * L;
  bf16* dx = static_cast<bf16*>(a.dx);

  stage<N>(Bs, a.B, bb, a.s, a.g, gg, t0);
  stage<N>(Cs, a.C, bb, a.s, a.g, gg, t0);
  stage<P>(xs, a.x, bb, a.s, a.h, h0, t0);
  stage<P>(dys, a.dy, bb, a.s, a.h, h0, t0);
  cp_async_commit();

  float dBa[NQ][4][4];             // this warp's dB over the block's heads
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dBa[q][nt][e] = 0.f;
  for (int idx = tid; idx < L * SN; idx += THREADS) dCs[idx] = 0.f;

  for (int k = 0; k < nh; ++k) {
    const int hh = h0 + k;
    const size_t bh = size_t(bb) * a.h + hh;
    const float A = a.A[hh];
    if (warp == 0) {
      float dtr[2];
      load_dt(dtr, a, bb, hh, t0);
      chunk_cumsum(dtr, A, dts, cas, eca, dec);
    }
    const float fac = a.facs[bh * a.nc + c];
    float du[4][4];                // rows 16 t .., columns 32 hf + 8 nt ..
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) du[nt][e] = 0.f;
    float dot = 0.f, qa[2] = {0.f, 0.f};

    for (int q = 0; q < NQ; ++q) {
      // the slab's S and dS' = local + fac x the group's outgoing gradient,
      // split; <dS', S>
      const size_t off = (bh * a.nc + c) * N * P + size_t(64 * q) * P;
      const float* Sg = a.cstates + off;
      const float* Dl = a.dsloc + off;
      const float* Do = a.G > 1
          ? a.dstates + (bh * a.G + grp) * N * P + 64 * q * P : nullptr;
      // four rounds of loads in flight where the registers allow (n 128,
      // one block an SM); one at n 64, whose two blocks an SM leave 128
#pragma unroll(N == 128 ? 4 : 1)
      for (int idx = tid; idx < 64 * P / 4; idx += THREADS) {
        const int r = idx / (P / 4), c4 = 4 * (idx % (P / 4));
        const float4 sv = *reinterpret_cast<const float4*>(Sg + r * P + c4);
        float4 dv = *reinterpret_cast<const float4*>(Dl + r * P + c4);
        if (Do != nullptr) {
          const float4 o = *reinterpret_cast<const float4*>(Do + r * P + c4);
          dv.x = dv.x + fac * o.x;
          dv.y = dv.y + fac * o.y;
          dv.z = dv.z + fac * o.z;
          dv.w = dv.w + fac * o.w;
        }
        dot += dv.x * sv.x + dv.y * sv.y + dv.z * sv.z + dv.w * sv.w;
        uint32_t w0[PARTS], w1[PARTS], w2[PARTS], w3[PARTS];
        split2(sv.x, sv.y, w0);
        split2(sv.z, sv.w, w1);
        split2(dv.x, dv.y, w2);
        split2(dv.z, dv.w, w3);
#pragma unroll
        for (int pt = 0; pt < PARTS; ++pt) {
          *reinterpret_cast<uint2*>(S3 + pt * 64 * SB + r * SB + c4) =
              make_uint2(w0[pt], w1[pt]);
          *reinterpret_cast<uint2*>(D3 + pt * 64 * SB + r * SB + c4) =
              make_uint2(w2[pt], w3[pt]);
        }
      }
      if (q == 0) cp_async_wait<0>();          // this head's x and dy
      __syncthreads();

      // dB += dec dt (x dS'), then dC += exp(c) (dy S) and q_i, over
      // k = p for the slab's columns of this half
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {
        const bf16* At = which ? dys : xs;
        const bf16* Bt = which ? S3 : D3;
        float tt[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tt[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4];
          ldsm(af, At + a_mk(SB, 16 * t, 16 * kk, lane));
#pragma unroll
          for (int np = 0; np < 2; ++np)
#pragma unroll
            for (int pt = PARTS - 1; pt >= 0; --pt) {
              uint32_t bf[4];
              ldsm(bf, Bt + pt * 64 * SB
                           + b_nk(SB, 32 * hf + 16 * np, 16 * kk, lane));
              mma_pair(tt[2 * np], tt[2 * np + 1], af, bf);
            }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * t + g + 8 * (e >> 1);
            if (which == 0) {
              dBa[q][nt][e] += dec[r] * dts[r] * tt[nt][e];
            } else {
              const int col = 64 * q + 32 * hf + 8 * nt + 2 * t4 + (e & 1);
              const float ci = eca[r] * tt[nt][e];
              qa[e >> 1] += __bfloat162float(Cs[r * SN + col]) * ci;
              dCs[r * SN + col] += ci;      // this thread's own element
            }
          }
      }
      // du += B dS'^T over the slab (k = n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        ldsm(af, Bs + a_mk(SN, 16 * t, 64 * q + 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np)
#pragma unroll
          for (int pt = PARTS - 1; pt >= 0; --pt) {
            uint32_t bf[4];
            ldsm_t(bf, D3 + pt * 64 * SB
                           + b_kn(SB, 16 * kk, 32 * hf + 16 * np, lane));
            mma_pair(du[2 * np], du[2 * np + 1], af, bf);
          }
      }
      __syncthreads();             // the slab (and then W, GE) is rewritten
    }

    // dus = dec (B dS'^T); r_j = dt_j x_j . dus_j; q_i; <dS', S>
    {
      float rr[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * t + g + 8 * hr;
          const float2 xv = ld_bf2(xs + r * SB + 32 * hf + 8 * nt + 2 * t4);
          du[nt][2 * hr] *= dec[r];
          du[nt][2 * hr + 1] *= dec[r];
          rr[hr] += xv.x * du[nt][2 * hr] + xv.y * du[nt][2 * hr + 1];
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float v = rr[hr], u = qa[hr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        u += __shfl_xor_sync(0xffffffffu, u, 1);
        u += __shfl_xor_sync(0xffffffffu, u, 2);
        const int r = 16 * t + g + 8 * hr;
        if (t4 == 0) {
          rp[hf * L + r] = v * dts[r];
          qp[hf * L + r] = u;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) red[(k & 1) * 8 + warp] = dot;
      // du waits beside W and GE (this thread's own elements)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(
              duS + (16 * t + g + 8 * hr) * SB + 32 * hf + 8 * nt + 2 * t4) =
              make_float2(du[nt][2 * hr], du[nt][2 * hr + 1]);
    }

    // W and GE on the sub-tiles (t, jt), jt <= t, jt = hf mod 2: the
    // products, the decay, the row and column sums of W o G, the split
    {
      float rs[2] = {0.f, 0.f};
      for (int jt = hf; jt <= t; jt += 2) {
        float cb[2][4], gx[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[nt][e] = gx[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t ca[4], bf[4];
          ldsm(ca, Cs + a_mk(SN, 16 * t, 16 * kk, lane));
          ldsm(bf, Bs + b_nk(SN, 16 * jt, 16 * kk, lane));
          mma_pair(cb[0], cb[1], ca, bf);
        }
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {
          uint32_t ya[4], xf[4];
          ldsm(ya, dys + a_mk(SB, 16 * t, 16 * kk, lane));
          ldsm(xf, xs + b_nk(SB, 16 * jt, 16 * kk, lane));
          mma_pair(gx[0], gx[1], ya, xf);
        }
        float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        const int wt = tri_tile(t, jt);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int rl = g + 8 * hr, i = 16 * t + rl;
            float w2[2], ge2[2];
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int j = 16 * jt + 8 * nt + 2 * t4 + e2;
              const float ee = i >= j ? expf(cas[i] - cas[j]) : 0.f;
              const float gv = gx[nt][2 * hr + e2] * dts[j];
              w2[e2] = cb[nt][2 * hr + e2] * ee;
              ge2[e2] = gv * ee;
              const float m = w2[e2] * gv;
              rs[hr] += m;
              cs[nt][e2] += m;
            }
            uint32_t ww[PARTS], gw[PARTS];
            split2(w2[0], w2[1], ww);
            split2(ge2[0], ge2[1], gw);
            const int o = wt + tri_off(rl, 8 * nt + 2 * t4);
#pragma unroll
            for (int pt = 0; pt < PARTS; ++pt) {
              *reinterpret_cast<uint32_t*>(W3 + pt * TRI + o) = ww[pt];
              *reinterpret_cast<uint32_t*>(GE3 + pt * TRI + o) = gw[pt];
            }
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            float v = cs[nt][e2];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) colp[t * L + 16 * jt + 8 * nt + 2 * t4 + e2] = v;
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float v = rs[hr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t4 == 0) rowp[hf * L + 16 * t + g + 8 * hr] = v;
      }
    }
    __syncthreads();

    // du += W^T dy over the sub-tiles (it, t), it >= t
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 v = *reinterpret_cast<const float2*>(
            duS + (16 * t + g + 8 * hr) * SB + 32 * hf + 8 * nt + 2 * t4);
        du[nt][2 * hr] = v.x;
        du[nt][2 * hr + 1] = v.y;
      }
    const int o_t =
        tri_off((lane & 7) + 8 * (lane >> 4), 8 * ((lane >> 3) & 1));
    for (int it = t; it < 4; ++it) {
      uint32_t wa[PARTS][4];
#pragma unroll
      for (int pt = 0; pt < PARTS; ++pt)
        ldsm_t(wa[pt], W3 + pt * TRI + tri_tile(it, t) + o_t);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_t(bf, dys + b_kn(SB, 16 * it, 32 * hf + 16 * np, lane));
#pragma unroll
        for (int pt = PARTS - 1; pt >= 0; --pt)
          mma_pair(du[2 * np], du[2 * np + 1], wa[pt], bf);
      }
    }
    // dx = dt du; x . du
    {
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * t + g + 8 * hr, tt = t0 + r;
        bf16* row = dx + ((size_t(bb) * a.s + tt) * a.h + hh) * P + 32 * hf
                    + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 xv = ld_bf2(xs + r * SB + 32 * hf + 8 * nt + 2 * t4);
          xd[hr] += xv.x * du[nt][2 * hr] + xv.y * du[nt][2 * hr + 1];
          if (tt < a.s)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt) =
                __floats2bfloat162_rn(du[nt][2 * hr] * dts[r],
                                      du[nt][2 * hr + 1] * dts[r]);
        }
        float v = xd[hr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t4 == 0) xp[hf * L + r] = v;
      }
    }
    // dB += GE^T C over the sub-tiles (it, t), it >= t
    for (int it = t; it < 4; ++it) {
      uint32_t ga[PARTS][4];
#pragma unroll
      for (int pt = 0; pt < PARTS; ++pt)
        ldsm_t(ga[pt], GE3 + pt * TRI + tri_tile(it, t) + o_t);
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldsm_t(bf, Cs + b_kn(SN, 16 * it, 64 * q + 32 * hf + 16 * np,
                                    lane));
#pragma unroll
          for (int pt = PARTS - 1; pt >= 0; --pt)
            mma_pair(dBa[q][2 * np], dBa[q][2 * np + 1], ga[pt], bf);
        }
    }
    // dC += GE B over the sub-tiles (t, jt), jt <= t, on this warp's
    // elements of dCs
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 v = *reinterpret_cast<const float2*>(
              dCs + (16 * t + g + 8 * hr) * SN + 64 * q + 32 * hf + 8 * nt
              + 2 * t4);
          acc[nt][2 * hr] = v.x;
          acc[nt][2 * hr + 1] = v.y;
        }
      for (int jt = 0; jt <= t; ++jt) {
        uint32_t ga[PARTS][4];
        const int o = tri_tile(t, jt) + tri_off(lane & 15, 8 * (lane >> 4));
#pragma unroll
        for (int pt = 0; pt < PARTS; ++pt) ldsm(ga[pt], GE3 + pt * TRI + o);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldsm_t(bf, Bs + b_kn(SN, 16 * jt, 64 * q + 32 * hf + 16 * np,
                               lane));
#pragma unroll
          for (int pt = PARTS - 1; pt >= 0; --pt)
            mma_pair(acc[2 * np], acc[2 * np + 1], ga[pt], bf);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(
              dCs + (16 * t + g + 8 * hr) * SN + 64 * q + 32 * hf + 8 * nt
              + 2 * t4) = make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
    }
    __syncthreads();               // x, dy, W, GE are read; the vectors set
    if (k + 1 < nh) {              // the next head's x and dy
      stage<P>(xs, a.x, bb, a.s, a.h, hh + 1, t0);
      stage<P>(dys, a.dy, bb, a.s, a.h, hh + 1, t0);
      cp_async_commit();
    }

    // warp 0: dc, da = its reverse cumsum, ddt, this head's dA part
    if (warp == 0) {
      float dA_acc = 0.f;
      const int i0 = 2 * lane, i1 = i0 + 1;
      float rsum = rp[i0] + rp[L + i0] + rp[i1] + rp[L + i1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      float dS = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) dS += red[(k & 1) * 8 + w];
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + e;
        float col = 0.f;
        for (int tt = i / 16; tt < 4; ++tt) col += colp[tt * L + i];
        d[e] = rowp[i] + rowp[L + i] - col + qp[i] + qp[L + i]
               - (rp[i] + rp[L + i]);
      }
      if (i1 == L - 1) d[1] += expf(cas[L - 1]) * dS + rsum;
      float run = d[0] + d[1];     // suffix sums over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, run, o);
        if (lane + o < 32) run += v;
      }
      const float das[2] = {run, run - d[0]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + e, tt = t0 + i;
        if (tt < a.s)
          a.ddt[(size_t(bb) * a.s + tt) * a.h + hh] =
              xp[i] + xp[L + i] + A * das[e];
        dA_acc += dts[i] * das[e];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dA_acc += __shfl_xor_sync(0xffffffffu, dA_acc, o);
      if (lane == 0) a.dAp[bh * a.nc + c] = dA_acc;
    }
  }

  // this block's dB and dC, summed over its heads
  const int R = a.g * a.nsplit, row = gg * a.nsplit + sp;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int tt = t0 + 16 * t + g + 8 * hr;
    if (tt >= a.s) continue;
    const size_t base = ((size_t(bb) * a.s + tt) * R + row) * N + 32 * hf
                        + 2 * t4;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const size_t o = base + 64 * q + 8 * nt;
        *reinterpret_cast<float2*>(a.dBp + o) =
            make_float2(dBa[q][nt][2 * hr], dBa[q][nt][2 * hr + 1]);
        *reinterpret_cast<float2*>(a.dCp + o) =
            *reinterpret_cast<const float2*>(
                dCs + (16 * t + g + 8 * hr) * SN + 64 * q + 32 * hf + 8 * nt
                + 2 * t4);
      }
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

template <int N>
int launch_bf16(const BwdArgs& a, cudaStream_t s) {
  cudaError_t err;
  err = cudaFuncSetAttribute(ssd_bwd_walk_bf16<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             walk_smem_bytes<N>());
  if (err != cudaSuccess) return int(err);
  ssd_bwd_walk_bf16<N><<<dim3(2 * a.G, a.h, a.b), THREADS,
                         walk_smem_bytes<N>(), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (a.G > 1) {
    ssd_bwd_pass<N><<<dim3(N * P / PASS_THREADS, a.h, a.b), PASS_THREADS, 0,
                      s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  err = cudaFuncSetAttribute(ssd_bwd_chunk_bf16<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             chunk_smem_bytes<N>());
  if (err != cudaSuccess) return int(err);
  ssd_bwd_chunk_bf16<N><<<dim3(a.nc, a.g * a.nsplit, a.b), THREADS,
                          chunk_smem_bytes<N>(), s>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Heads of one B/C group a bf16 chunk block takes (the wrapper's nsplit =
// ceil((h / g) / heads)).
extern "C" int ssd_scan_bwd_heads() { return HEADS; }

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 (x, B, C, dy and dx; dt, A and the rest float32).
// Supported: chunk 64, p 64, n 64 or 128, group 8.  With G = ceil(nc / 8)
// groups of the nc = ceil(s / 64) chunks: `states` (b, h, G, n, p) are the
// forward's group states (null when G = 1); `cstates` (b, h, nc, n, p),
// `dstates` (b, h, G, n, p; null when G = 1) and `gdecay` (b, h, G) are
// float32 scratch, and so are, for bf16 only, `dsloc` (b, h, nc, n, p) and
// `facs` (b, h, nc) (null for float32).  Outputs: dx (b, s, h, p), ddt
// (b, s, h), and float32 dBp / dCp and dAp: for float32 per head, (b, s,
// h, n) and (b, h, G); for bf16 (b, s, g * nsplit, n), each row the sum
// over its block's heads, nsplit = ceil((h / g) / ssd_scan_bwd_heads()),
// and (b, h, nc).  Launches three kernels (two when G = 1) on `stream`,
// does not synchronise, allocates nothing; returns a CUDA error code
// (0 = success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* dy, const float* states, float* cstates,
    float* dstates, float* gdecay, float* dsloc, float* facs, void* dx,
    float* ddt, float* dBp, float* dCp, float* dAp, int b, int s, int h,
    int p, int g, int n, int chunk, int group, int dtype, void* stream) {
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
  if (dtype == 1 && (dsloc == nullptr || facs == nullptr ||
                     size_t(g) * nsplit > 65535))
    return int(cudaErrorInvalidValue);
  const BwdArgs a{x, dt, A, B, C, dy, G > 1 ? states : nullptr, cstates,
                  dstates, gdecay, dsloc, facs, dx, ddt, dBp, dCp, dAp, b, s,
                  h, g, G, nc, nsplit};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && n == 64) return launch_f32<64>(a, st);
  if (dtype == 0 && n == 128) return launch_f32<128>(a, st);
  if (dtype == 1 && n == 64) return launch_bf16<64>(a, st);
  if (dtype == 1 && n == 128) return launch_bf16<128>(a, st);
  return int(cudaErrorInvalidValue);
}
#endif
