// The gradient of the Mamba2 SSD chunked scan for Hopper (sm_90a)
// [arXiv:2405.21060]: given dy, the gradients of x, dt, A, B and C of the
// scan from a zero state; float32 or bfloat16 x/B/C/dy.
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
// The split mirrors the forward's, reversed.  The forward keeps its group
// states (the float32 incoming state of each group of GROUP chunks, which
// its launch 2 writes), and three launches follow:
//
//   1. ssd_bwd_state, grid (G, h, b): each group walks its chunks forward
//      from its saved state, writing every chunk's incoming state to
//      scratch (b, h, nc, N, P); each group but the first also sums its own
//      rows' part of the gradient of its incoming state, sum_k D_k
//      exp(c) C^T dy over its chunks k (D_k the product of the decays of
//      the chunks before k), and writes the group's decay;
//   2. ssd_bwd_pass, grid (N P / 256, h, b): walks the groups from the last
//      to the first and leaves in each slot the gradient of that group's
//      outgoing state (no launch when G = 1);
//   3. ssd_bwd_scan, grid (G, h, b): each group walks its chunks in reverse
//      from that gradient, carrying dS in shared memory, and writes dx and
//      ddt, per-head float32 dB and dC partials (b, s, h, N) and a
//      per-(batch, head, group) dA partial.
//
// The wrapper sums the per-head partials over the heads of each B/C group
// and the dA partials over batch and groups.  No atomics: every output
// element is written by one thread, so two runs give the same bits.  A
// ragged tail reads as x = B = C = dy = 0, dt = 0, and its rows are not
// written.
//
// Every product runs in float32 on the CUDA cores (bf16 operands are
// widened on load), as 4 x 4 register tiles per thread over operands in
// shared memory read as float4, in whichever of the two layouts the
// operand has there (`mm`).  Nothing is rounded before the outputs: dx in
// x's dtype, the partials, ddt and dA in float32.
//
// Layout: x/dy/dx (b, s, h, p), dt/ddt (b, s, h) float32, A (h,) float32,
// B/C (b, s, g, n); all contiguous, 16-byte aligned.
//
// What bounds it: at zamba2's shape (b = 2, s = 4096, h = 64, p = 64,
// g = 1, n = 64, bf16) the function moves ~209 MB (x, dy, dx, B, C, dB,
// dC, dt, ddt: ~0.062 ms at 3.35 TB/s) and does ~2.5 x the forward's
// ~13 GFLOP of products (~0.033 ms on the bf16 tensor cores), so it is
// bound by bytes.  This first version is bound by neither: it runs ~47
// GFLOP of float32 products (W and GE are kept dense over the L x L
// tile, both triangles) on the CUDA cores (67 TFLOP/s at best), with one
// block of 256 threads an SM (~144 KB of shared memory at n = 64, ~207 KB
// at n = 128) and ~0.27 GB of float32 scratch traffic (chunk states,
// per-head partials).  What a faster version does about it: the products
// on the tensor cores, the masked triangles skipped, the per-head
// partials summed in the kernel.

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

// shared-memory row stride of a tile of W columns: float4 rows that start
// 16 bytes apart in the bank map
__host__ __device__ constexpr int ld(int w) { return w + 4; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(p + 2) =
      __floats2bfloat162_rn(v[2], v[3]);
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
  void* dx;
  float* ddt;
  float* dBh;                      // (b, s, h, N) per-head partials
  float* dCh;
  float* dAp;                      // (b, h, G)
  int b, s, h, g, G, nc;
};

// rows [t0, t0 + L) of head `hd` of a (b, s, heads, W) tensor into a float32
// tile of stride ld(W); rows >= s read as 0
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, const void* src_,
                                          int bb, int s, int heads, int hd,
                                          int t0) {
  const T* src = static_cast<const T*>(src_);
  for (int idx = threadIdx.x; idx < L * W; idx += THREADS) {
    const int r = idx / W, c = idx % W, t = t0 + r;
    dst[r * ld(W) + c] =
        t < s ? to_f(src[((size_t(bb) * s + t) * heads + hd) * W + c]) : 0.f;
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

__device__ __forceinline__ void load_dt(float* dts, const BwdArgs& a,
                                        int bb, int hh, int t0) {
  if (threadIdx.x < L) {
    const int t = t0 + threadIdx.x;
    dts[threadIdx.x] = t < a.s ? a.dt[(size_t(bb) * a.s + t) * a.h + hh] : 0.f;
  }
}

// Warp 0: the chunk's cumsum of a = dt A by a warp scan (two rows a lane,
// the forward's order); cas = c, eca = exp(c), dec = exp(c_L - c)
__device__ __forceinline__ void chunk_cumsum(const float* dts, float A,
                                             float* cas, float* eca,
                                             float* dec) {
  const int lane = threadIdx.x;
  const float d0 = dts[2 * lane] * A, d1 = dts[2 * lane + 1] * A;
  float run = d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  const float before = __shfl_up_sync(0xffffffffu, run, 1);
  const float c0 = (lane ? before : 0.f) + d0, c1 = c0 + d1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
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

// ---------------------------------------------------------------------------
// launch 1: chunk states, each group's own state gradient and decay
// ---------------------------------------------------------------------------

template <int N>
constexpr int state_smem_bytes() {
  return (2 * L * ld(P) + 2 * L * ld(N) + 5 * L) * 4;
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_state(BwdArgs a) {
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
      load_rows<T, P>(xs, a.x, bb, a.s, a.h, hh, t0);
      load_rows<T, N>(Bs, a.B, bb, a.s, a.g, gg, t0);
    }
    if (grp > 0) {
      load_rows<T, P>(dys, a.dy, bb, a.s, a.h, hh, t0);
      load_rows<T, N>(Cs, a.C, bb, a.s, a.g, gg, t0);
    }
    load_dt(dts, a, bb, hh, t0);
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, A, cas, eca, dec);
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

// ---------------------------------------------------------------------------
// launch 2: the gradient of every group's outgoing state, last to first
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(PASS_THREADS) ssd_bwd_pass(BwdArgs a) {
  const int idx = blockIdx.x * PASS_THREADS + threadIdx.x;
  const size_t base = (size_t(blockIdx.z) * a.h + blockIdx.y) * a.G;
  float* ds = a.dstates + base * N * P + idx;
  float run = 0.f;                 // the last group's outgoing gradient
  for (int grp = a.G - 1; grp > 0; --grp) {
    const float own = ds[size_t(grp) * N * P];
    ds[size_t(grp) * N * P] = run;
    run = own + a.gdecay[base + grp] * run;
  }
  ds[0] = run;
}

// ---------------------------------------------------------------------------
// launch 3: each group's chunks in reverse
// ---------------------------------------------------------------------------

constexpr int VEC = 9 * L + 8 * L + 32;    // per-row vectors and scratch

template <int N>
constexpr int scan_smem_bytes() {
  return (2 * L * ld(P) + 2 * L * ld(N) + 2 * N * ld(P) + 2 * L * ld(L) + VEC)
         * 4;
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_scan(BwdArgs a) {
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
  T* dx = static_cast<T*>(a.dx);

  if (a.G > 1)
    load_state<N>(dSt, a.dstates + (bh * a.G + grp) * N * P);
  else
    for (int idx = tid; idx < N * P; idx += THREADS)
      dSt[(idx / P) * ld(P) + idx % P] = 0.f;
  float dA_acc = 0.f;              // warp 0: sum of dt da over the group

  for (int c = c1 - 1; c >= c0; --c) {
    const int t0 = c * L;
    load_rows<T, P>(xs, a.x, bb, a.s, a.h, hh, t0);
    load_rows<T, P>(dys, a.dy, bb, a.s, a.h, hh, t0);
    load_rows<T, N>(Bs, a.B, bb, a.s, a.g, gg, t0);
    load_rows<T, N>(Cs, a.C, bb, a.s, a.g, gg, t0);
    load_state<N>(St, a.cstates + (bh * a.nc + c) * N * P);
    load_dt(dts, a, bb, hh, t0);
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, A, cas, eca, dec);
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
          if (t < a.s) store4(a.dCh + ((size_t(bb) * a.s + t) * a.h + hh) * N
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
        if (t < a.s) store4(a.dBh + ((size_t(bb) * a.s + t) * a.h + hh) * N
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

template <typename T, int N>
int launch(const BwdArgs& a, cudaStream_t s) {
  cudaError_t err;
  err = cudaFuncSetAttribute(ssd_bwd_state<T, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             state_smem_bytes<N>());
  if (err != cudaSuccess) return int(err);
  ssd_bwd_state<T, N><<<dim3(a.G, a.h, a.b), THREADS, state_smem_bytes<N>(),
                        s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (a.G > 1) {
    ssd_bwd_pass<N><<<dim3(N * P / PASS_THREADS, a.h, a.b), PASS_THREADS, 0,
                      s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  err = cudaFuncSetAttribute(ssd_bwd_scan<T, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             scan_smem_bytes<N>());
  if (err != cudaSuccess) return int(err);
  ssd_bwd_scan<T, N><<<dim3(a.G, a.h, a.b), THREADS, scan_smem_bytes<N>(),
                       s>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 (x, B, C, dy and dx; dt, A and the rest float32).
// Supported: chunk 64, p 64, n 64 or 128, group 8.  `states` (b, h, G, n,
// p) are the forward's group states (null when G = 1); `cstates` (b, h,
// nc, n, p), `dstates` (b, h, G, n, p; null when G = 1) and `gdecay` (b, h,
// G) are float32 scratch; outputs dx (b, s, h, p), ddt (b, s, h), dBh / dCh
// (b, s, h, n) per-head partials and dAp (b, h, G), for G = ceil(nc / 8)
// groups of the nc = ceil(s / 64) chunks.  Launches three kernels (two
// when G = 1) on `stream`, does not synchronise, allocates nothing;
// returns a CUDA error code (0 = success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* dy, const float* states, float* cstates,
    float* dstates, float* gdecay, void* dx, float* ddt, float* dBh,
    float* dCh, float* dAp, int b, int s, int h, int p, int g, int n,
    int chunk, int group, int dtype, void* stream) {
  if (b < 0 || s < 0 || h < 1 || g < 1 || h % g != 0 || b > 65535 ||
      h > 65535)
    return int(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return 0;
  if (chunk != L || p != P || group != GROUP)
    return int(cudaErrorInvalidValue);
  const int nc = (s + L - 1) / L;
  const int G = (nc + GROUP - 1) / GROUP;
  if (G > 1 && (states == nullptr || dstates == nullptr))
    return int(cudaErrorInvalidValue);
  const BwdArgs a{x, dt, A, B, C, dy, G > 1 ? states : nullptr, cstates,
                  dstates, gdecay, dx, ddt, dBh, dCh, dAp, b, s, h, g, G, nc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && n == 64) return launch<float, 64>(a, st);
  if (dtype == 0 && n == 128) return launch<float, 128>(a, st);
  if (dtype == 1 && n == 64) return launch<__nv_bfloat16, 64>(a, st);
  if (dtype == 1 && n == 128) return launch<__nv_bfloat16, 128>(a, st);
  return int(cudaErrorInvalidValue);
}
#endif
