// Mamba2 SSD chunked scan for Hopper (sm_90a) [arXiv:2405.21060], from a
// zero state, returning y only; float32 or bfloat16 x/B/C.  Built for p 64
// and n 64 or 128; the wrapper zero-pads a narrower x, B or C to them
// (padded columns add exact zeros to every sum) and slices y back.
//
// Replaces the TPU Pallas kernel src/repro/kernels/ssd_scan.py:_ssd_kernel
// (launcher `ssd_scan`, its pallas_call).  That kernel walks (batch, head,
// chunk) with the chunk axis sequential and keeps the (P, N) float32 state
// in VMEM scratch.  On the TPU the sequential grid is free; on the card a
// block per (batch, head) walking every chunk leaves most SMs idle.  So
// the chunk axis is split into groups of GROUP chunks, in three launches:
//
//   1. ssd_kernel_state_*, grid (G - 1, h, b): each group but the last runs
//      its chunks from a zero state, keeping only what the state update
//      needs; it writes the group's end state (N x P f32) and its decay
//      (the product of exp(cA_last) over its chunks) to scratch;
//   2. ssd_kernel_pass, grid (N P / 256, h, b): walks the groups in order
//      and overwrites each slot with the group's incoming state;
//   3. ssd_kernel_scan_*, grid (G, h, b): each group scans its chunks from
//      its incoming state (the whole per-chunk body below).
//
// Launch 2 leaves the float32 incoming state of every group in `states`;
// when autograd needs the gradient the wrapper keeps that buffer for the
// backward (csrc/ssd_scan_bwd.cu) instead of dropping it: the launches are
// the same either way.
//
// A scan of one group (s <= GROUP * L) is launch 3 alone.  GROUP = 8:
// at the prefill shape (64 chunks) that makes 8 groups, 1024 blocks in
// launch 3 and 16.8 MB of group states, which stay in the 50 MB L2;
// per-chunk states would be 134 MB of f32 traffic.  A single-pass
// decoupled look-back was not taken: it needs no redundant state
// product, but it chains 64 waits per sequence and spins on flags.
//
// Per chunk of L = 64 rows, all with float32 accuracy (as _ssd_kernel):
//   dA = dt * A, cA = inclusive cumsum(dA)            (a warp scan)
//   W[i][j] = (C_i . B_j) * exp(cA_i - cA_j) for i >= j, else 0
//   y_i = sum_j W[i][j] (dt_j x_j) + (C_i . state) * exp(cA_i)
//   state <- state * exp(cA_last) + sum_j (B_j exp(cA_last - cA_j)) x_j dt_j
// B/C head: h / (H / G).  A ragged tail (s not a multiple of L) is read as
// x = B = C = 0, dt = 0 — the reference's dt = 0 padding, which leaves the
// state unchanged — and its rows are not written.  The sum order differs
// from the reference's (warp scan, group composition, fmaf chains), so
// results agree to a tolerance, not bit for bit.
//
// Inside a block (256 threads): the next chunk's x/B/C rows are copied
// into a staging area by cp.async (zero-filled past s) and its dt read
// into registers while the current chunk computes; the chunk's cumsum is
// a warp scan.
//
// bfloat16 (ssd_kernel_state_bf16, ssd_kernel_scan_bf16): every product
// runs on the tensor cores (mma.sync m16n8k16) with float32 accuracy.
// B and C are bf16, so C B^T is exact; C state^T and B^T (x dt decay)
// have one exact bf16 operand and one f32 operand, which is split into
// three bf16 parts (v = hi + mid + lo carries all 24 bits of v); W (x dt)
// has two f32 operands, both split, summing the six part products down
// to 2^-24.  Products of bf16 parts are exact in f32 and sums are f32, so
// the error is float32 rounding, as the card check of the group states
// against the plain float32 states shows.  W stays in registers (the
// C B^T accumulators of a warp's 16 rows are decayed, masked and split
// into W's A fragments); the state stays in the accumulator registers of
// the warps that update it, with its split copy in shared memory for
// C state^T.  ~109 KB of shared memory: two blocks an SM.
//
// float32 (ssd_kernel_state_f32, ssd_kernel_scan_f32): the CUDA cores,
// 4 x 4 register tiles over float32 operands in shared memory, both read
// as float4 along the contraction index (C, W and B*decay stored
// k-major), so a k-step is 2 shared loads for 16 FMAs; a warp's W (x dt)
// stops at its own rows' diagonal.
//
// Layout: x/y (b, s, h, p), dt (b, s, h) float32, A (h,) float32, B/C
// (b, s, g, n), all contiguous and 16-byte aligned.
//
// What bounds it: at the slice's shape (b = 2, s = 4096, h = 64, p = 64,
// g = 1, n = 64, bf16) a call must move ~137 MB (~0.041 ms at 3.35 TB/s)
// and do ~13 GFLOP of products.  The split adds its own traffic, mostly
// in L2: ~63 MB of f32 group states and ~61 MB of x/B/dt re-read by
// launch 1.  What holds the bf16 path back now: launch 3's per-chunk
// chain of five barriers with 8 warps a block, the split's extra tensor
// work (up to 6 products for W (x dt)), and launch 1's second pass over x.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;              // chunk length
constexpr int P = 64;              // head dim
constexpr int GROUP = 8;           // chunks per group
constexpr int THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr int WS = L + 4;          // smem row stride of W^T (conflict-free writes)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
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
// bfloat16: the products on the tensor cores, f32 operands split in three
// ---------------------------------------------------------------------------
//
// B and C are bf16, so C B^T, C state^T and B^T (x dt decay) have one exact
// operand; the f32 operand (state, x dt decay) is split as v = hi + mid +
// lo, three bf16 whose sum carries v's 24 bits, and each part goes
// through mma.sync (bf16 products are exact in f32, sums are f32).  W (x dt)
// has two f32 operands: both are split and the six products whose order is
// at least 2^-24 are summed (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid).
// W never leaves registers: the C B^T accumulators of a warp's 16 rows are
// decayed, masked and split into the A fragments of W (x dt).  The state
// stays in the accumulator registers of the warps that update it; its
// split copy in shared memory feeds C state^T.

constexpr int SB = P + 8;          // row stride of the bf16 split tiles

__device__ __forceinline__ void split3(float v, __nv_bfloat16 part[3]) {
  part[0] = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(part[0]);   // exact
  part[1] = __float2bfloat16_rn(r);
  part[2] = __float2bfloat16_rn(r - __bfloat162float(part[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the three bf16x2 words of the split of (u, v)
__device__ __forceinline__ void split3x2(float u, float v, uint32_t w[3]) {
  __nv_bfloat16 a[3], b[3];
  split3(u, a);
  split3(v, b);
#pragma unroll
  for (int q = 0; q < 3; ++q) w[q] = pack2(a[q], b[q]);
}

// two n-tiles of one A fragment: c0 += a . b[0..1], c1 += a . b[2..3]
__device__ __forceinline__ void mma_pair(float c0[4], float c1[4],
                                         const uint32_t a[4],
                                         const uint32_t b[4]) {
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// store the split of (u, v) at row r, column c of the three tiles
__device__ __forceinline__ void store_split(__nv_bfloat16* tiles, int plane,
                                            int r, int c, float u, float v) {
  uint32_t w[3];
  split3x2(u, v, w);
#pragma unroll
  for (int q = 0; q < 3; ++q)
    *reinterpret_cast<uint32_t*>(tiles + q * plane + r * SB + c) = w[q];
}

// st[q][nt] (rows 64 q + 16 rt .. + 15, columns 32 half + 8 nt .. + 7 of
// the (N, P) state^T) = st * e_last + B^T (x dt decay): A = B^T by
// ldmatrix.trans from the bf16 staging rows, the three parts of
// x dt decay (xd3) by ldmatrix.trans
template <int N>
__device__ __forceinline__ void state_update_mma(float st[][4][4],
                                                 const __nv_bfloat16* br,
                                                 const __nv_bfloat16* xd3,
                                                 float e_last, int rt,
                                                 int half, int lane) {
  constexpr int SN = N + 8;
#pragma unroll
  for (int q = 0; q < N / 64; ++q) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[q][nt][e] *= e_last;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, br + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * SN
                                + 64 * q + 16 * rt + 8 * ((lane >> 3) & 1));
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
#pragma unroll
        for (int part = 2; part >= 0; --part) {    // small parts first
          uint32_t xb[4];
          ldmatrix_x4_trans(xb, xd3 + part * L * SB
                                    + (16 * kk + (lane & 7)
                                       + 8 * ((lane >> 3) & 1)) * SB
                                    + 32 * half + 8 * nt + 8 * (lane >> 4));
          mma_bf16(st[q][nt], af, xb[0], xb[1]);
          mma_bf16(st[q][nt + 1], af, xb[2], xb[3]);
        }
      }
    }
  }
}

// write the split of the state fragments to ss3 (N, P) x 3
template <int N>
__device__ __forceinline__ void store_state_split(__nv_bfloat16* ss3,
                                                  const float st[][4][4],
                                                  int rt, int half, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int q = 0; q < N / 64; ++q)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        store_split(ss3, N * SB, 64 * q + 16 * rt + g + 8 * r,
                    32 * half + 8 * nt + 2 * t4, st[q][nt][2 * r],
                    st[q][nt][2 * r + 1]);
}

template <int N>
constexpr int state_bf16_smem_bytes() {
  return 4 * L * 4 + (L * SB + L * (N + 8) + 3 * L * SB) * 2;
}

template <int N>
__global__ void __launch_bounds__(THREADS) ssd_kernel_state_bf16(SsdArgs a) {
  using T = __nv_bfloat16;
  constexpr int SN = N + 8;
  extern __shared__ float4 smem4[];
  float* dts = reinterpret_cast<float*>(smem4);
  float* cas = dts + L;
  float* dec = cas + L;
  float* eca = dec + L;
  T* xr = reinterpret_cast<T*>(eca + L);          // staging x (L, SB)
  T* br = xr + L * SB;                            // staging B (L, SN)
  T* xd3 = br + L * SN;                           // x dt decay, 3 parts

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rt = warp % 4, half = warp / 4;
  const int grp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int gg = hh / (a.h / a.g);
  const float A = a.A[hh];
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const int nc = (a.s + L - 1) / L;
  const int c0 = grp * GROUP, c1 = min(nc, c0 + GROUP);

  float st[N / 64][4][4];
#pragma unroll
  for (int q = 0; q < N / 64; ++q)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[q][nt][e] = 0.f;
  float total = 1.f;
  float dtr[2] = {0.f, 0.f};

  stage<T, P>(xr, x, bb, a.s, a.h, hh, c0 * L);
  cp_async_commit();
  stage<T, N>(br, Bm, bb, a.s, a.g, gg, c0 * L);
  cp_async_commit();
  if (tid < 32) load_dt(dtr, a, bb, hh, c0 * L);

  for (int c = c0; c < c1; ++c) {
    const bool more = c + 1 < c1;
    cp_async_wait<1>();            // x landed; B may still be in flight
    if (tid < 32) chunk_scan_warp0(dtr, A, dts, cas, dec, eca);
    __syncthreads();
    const float e_last = expf(cas[L - 1]);
    total *= e_last;
    for (int idx = tid; idx < L * P / 2; idx += THREADS) {
      const int j = idx / (P / 2), p = 2 * (idx % (P / 2));
      const float u = to_f(xr[j * SB + p]) * dts[j];
      const float v = to_f(xr[j * SB + p + 1]) * dts[j];
      store_split(xd3, L * SB, j, p, u * dec[j], v * dec[j]);
    }
    __syncthreads();
    if (more) {                    // the next x loads while this computes
      stage<T, P>(xr, x, bb, a.s, a.h, hh, (c + 1) * L);
      cp_async_commit();
      if (tid < 32) load_dt(dtr, a, bb, hh, (c + 1) * L);
      cp_async_wait<1>();          // B landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    state_update_mma<N>(st, br, xd3, e_last, rt, half, lane);
    __syncthreads();               // B and xd3 are free
    if (more) {
      stage<T, N>(br, Bm, bb, a.s, a.g, gg, (c + 1) * L);
      cp_async_commit();
    }
  }

  float* out = a.states + ((size_t(bb) * a.h + hh) * a.G + grp) * N * P;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int q = 0; q < N / 64; ++q)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            out + (64 * q + 16 * rt + g + 8 * r) * P + 32 * half + 8 * nt
            + 2 * t4) = make_float2(st[q][nt][2 * r], st[q][nt][2 * r + 1]);
  if (tid == 0) a.decay[(size_t(bb) * a.h + hh) * a.G + grp] = total;
}

template <int N>
constexpr int scan_bf16_smem_bytes() {
  return 4 * L * 4
         + (L * SB + 2 * L * (N + 8) + 6 * L * SB + 3 * N * SB) * 2;
}

template <int N>
__global__ void __launch_bounds__(THREADS, N == 64 ? 2 : 1)
ssd_kernel_scan_bf16(SsdArgs a) {
  using T = __nv_bfloat16;
  constexpr int SN = N + 8;
  constexpr int KN = N / 16;       // k-steps over the state dim
  extern __shared__ float4 smem4[];
  float* dts = reinterpret_cast<float*>(smem4);
  float* cas = dts + L;
  float* dec = cas + L;
  float* eca = dec + L;
  T* xr = reinterpret_cast<T*>(eca + L);          // staging x (L, SB)
  T* br = xr + L * SB;                            // staging B (L, SN)
  T* cr = br + L * SN;                            // staging C (L, SN)
  T* xs3 = cr + L * SN;                           // x dt, 3 parts (L, SB)
  T* xd3 = xs3 + 3 * L * SB;                      // x dt decay, 3 parts
  T* ss3 = xd3 + 3 * L * SB;                      // state^T, 3 parts (N, SB)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rt = warp % 4, half = warp / 4;       // 16 rows, 32 columns
  const int grp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int gg = hh / (a.h / a.g);
  const float A = a.A[hh];
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  T* y = static_cast<T*>(a.y);
  const int nc = (a.s + L - 1) / L;
  const int c0 = grp * GROUP, c1 = min(nc, c0 + GROUP);

  // this warp's part of the state: rows 64 q + 16 rt .., columns 32 half ..
  float st[N / 64][4][4];
  const float* in = a.states + ((size_t(bb) * a.h + hh) * a.G + grp) * N * P;
#pragma unroll
  for (int q = 0; q < N / 64; ++q)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 v = make_float2(0.f, 0.f);
        if (a.G > 1)               // the incoming state from launch 2
          v = *reinterpret_cast<const float2*>(
              in + (64 * q + 16 * rt + g + 8 * r) * P + 32 * half + 8 * nt
              + 2 * t4);
        st[q][nt][2 * r] = v.x;
        st[q][nt][2 * r + 1] = v.y;
      }
  store_state_split<N>(ss3, st, rt, half, lane);
  float dtr[2] = {0.f, 0.f};

  stage<T, P>(xr, x, bb, a.s, a.h, hh, c0 * L);
  cp_async_commit();
  stage<T, N>(cr, Cm, bb, a.s, a.g, gg, c0 * L);
  cp_async_commit();
  stage<T, N>(br, Bm, bb, a.s, a.g, gg, c0 * L);
  cp_async_commit();
  if (tid < 32) load_dt(dtr, a, bb, hh, c0 * L);

  for (int c = c0; c < c1; ++c) {
    const int t0 = c * L;
    const bool more = c + 1 < c1;
    cp_async_wait<2>();            // x landed; C and B may be in flight
    if (tid < 32) chunk_scan_warp0(dtr, A, dts, cas, dec, eca);
    __syncthreads();
    for (int idx = tid; idx < L * P / 2; idx += THREADS) {
      const int j = idx / (P / 2), p = 2 * (idx % (P / 2));
      const float u = to_f(xr[j * SB + p]) * dts[j];
      const float v = to_f(xr[j * SB + p + 1]) * dts[j];
      store_split(xs3, L * SB, j, p, u, v);
      store_split(xd3, L * SB, j, p, u * dec[j], v * dec[j]);
    }
    __syncthreads();
    if (more) {                    // the next x loads while this computes
      stage<T, P>(xr, x, bb, a.s, a.h, hh, t0 + L);
      cp_async_commit();
      if (tid < 32) load_dt(dtr, a, bb, hh, t0 + L);
      cp_async_wait<1>();          // C and B landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    {
      // C fragments of this warp's rows, for C B^T and C state^T
      uint32_t cf[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldmatrix_x4(cf[kk], cr + (16 * rt + (lane & 15)) * SN + 16 * kk
                                + 8 * (lane >> 4));
      // C B^T over the columns j <= 16 rt + 15 these rows need
      float cb[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          if (j > 2 * rt) continue;
          uint32_t bf[4];
          ldmatrix_x4(bf, br + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * SN
                              + 16 * kk + 8 * ((lane >> 3) & 1));
          mma_bf16(cb[j], cf[kk], bf[0], bf[1]);
          mma_bf16(cb[j + 1], cf[kk], bf[2], bf[3]);
        }
      // W = (C B^T) exp(cA_i - cA_j) for i >= j, in place
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j > 2 * rt + 1) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * rt + g + 8 * (e >> 1);
          const int col = 8 * j + 2 * t4 + (e & 1);
          cb[j][e] = i >= col ? cb[j][e] * expf(cas[i] - cas[col]) : 0.f;
        }
      }
      // y_intra = W (x dt): six split products, small ones first
      float yi[4][4], yo[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[nt][e] = yo[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > rt) continue;
        // the A fragments of W's columns 16 kk .. + 15, split in three
        uint32_t wa[3][4], w[3];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* src = cb[2 * kk + f / 2] + 2 * (f % 2);
          split3x2(src[0], src[1], w);
#pragma unroll
          for (int q = 0; q < 3; ++q) wa[q][f] = w[q];
        }
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t xb[3][4];
#pragma unroll
          for (int part = 0; part < 3; ++part)
            ldmatrix_x4_trans(xb[part], xs3 + part * L * SB
                                            + (16 * kk + (lane & 7)
                                               + 8 * ((lane >> 3) & 1)) * SB
                                            + 32 * half + 8 * nt
                                            + 8 * (lane >> 4));
          // (W part, x part): mid mid, lo hi, hi lo, mid hi, hi mid, hi hi
          mma_pair(yi[nt], yi[nt + 1], wa[1], xb[1]);
          mma_pair(yi[nt], yi[nt + 1], wa[2], xb[0]);
          mma_pair(yi[nt], yi[nt + 1], wa[0], xb[2]);
          mma_pair(yi[nt], yi[nt + 1], wa[1], xb[0]);
          mma_pair(yi[nt], yi[nt + 1], wa[0], xb[1]);
          mma_pair(yi[nt], yi[nt + 1], wa[0], xb[0]);
        }
      }
      // y_inter = C state^T: three parts of the state, small ones first
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2)
#pragma unroll
          for (int part = 2; part >= 0; --part) {
            uint32_t sb[4];
            ldmatrix_x4_trans(sb, ss3 + part * N * SB
                                      + (16 * kk + (lane & 7)
                                         + 8 * ((lane >> 3) & 1)) * SB
                                      + 32 * half + 8 * nt + 8 * (lane >> 4));
            mma_bf16(yo[nt], cf[kk], sb[0], sb[1]);
            mma_bf16(yo[nt + 1], cf[kk], sb[2], sb[3]);
          }
      // y = y_intra + y_inter exp(cA)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 16 * rt + g + 8 * r, t = t0 + i;
        if (t >= a.s) continue;
        const float e = eca[i];
        T* row = y + ((size_t(bb) * a.s + t) * a.h + hh) * P + 32 * half
                 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              yi[nt][2 * r] + yo[nt][2 * r] * e,
              yi[nt][2 * r + 1] + yo[nt][2 * r + 1] * e);
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt) = v;
        }
      }
    }
    __syncthreads();               // C, and the old state's split, are read
    if (more) {
      stage<T, N>(cr, Cm, bb, a.s, a.g, gg, t0 + L);
      cp_async_commit();
      state_update_mma<N>(st, br, xd3, expf(cas[L - 1]), rt, half, lane);
      store_state_split<N>(ss3, st, rt, half, lane);
    }
    __syncthreads();               // B, xd3 and the new state's split
    if (more) {
      stage<T, N>(br, Bm, bb, a.s, a.g, gg, t0 + L);
      cp_async_commit();
    }
  }
}

// launches 1 and 2 (more than one group), then launch 3 unless
// `states_only`
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

int dispatch(const SsdArgs& a, int n, int dtype, bool states_only,
             cudaStream_t s) {
  if (dtype == 0 && n == 64)
    return launch_split(ssd_kernel_state_f32<64>, state_f32_smem_bytes<64>(),
                        ssd_kernel_pass<64>, ssd_kernel_scan_f32<64>,
                        scan_f32_smem_bytes<64>(), n, a, states_only, s);
  if (dtype == 0 && n == 128)
    return launch_split(ssd_kernel_state_f32<128>,
                        state_f32_smem_bytes<128>(), ssd_kernel_pass<128>,
                        ssd_kernel_scan_f32<128>, scan_f32_smem_bytes<128>(),
                        n, a, states_only, s);
  if (dtype == 1 && n == 64)
    return launch_split(ssd_kernel_state_bf16<64>,
                        state_bf16_smem_bytes<64>(), ssd_kernel_pass<64>,
                        ssd_kernel_scan_bf16<64>, scan_bf16_smem_bytes<64>(),
                        n, a, states_only, s);
  if (dtype == 1 && n == 128)
    return launch_split(ssd_kernel_state_bf16<128>,
                        state_bf16_smem_bytes<128>(), ssd_kernel_pass<128>,
                        ssd_kernel_scan_bf16<128>,
                        scan_bf16_smem_bytes<128>(), n, a, states_only, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 (x, B, C and y; dt and A are float32).  Supported:
// chunk 64, p 64, n 64 or 128.  `states` (b, h, G, n, p) and `decay`
// (b, h, G) are float32 scratch for G = ceil(ceil(s / 64) / group)
// groups, unused (may be null) when G = 1; group must be 8.  Launches
// three kernels (one when G = 1) on `stream`, does not synchronise,
// allocates nothing; returns a CUDA error code (0 = success).
extern "C" int ssd_scan_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, void* y, float* states, float* decay, int b, int s, int h,
    int p, int g, int n, int chunk, int group, int dtype, void* stream) {
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
  return dispatch(a, n, dtype, false, static_cast<cudaStream_t>(stream));
}

// The incoming state of every group (launches 1 and 2 alone) into
// `states` (b, h, G, n, p): for the checks that hold the split products to
// the float32 tolerance.  Arguments as ssd_scan_launch without y; needs
// G > 1.
extern "C" int ssd_scan_states_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, float* states, float* decay, int b, int s, int h, int p,
    int g, int n, int chunk, int group, int dtype, void* stream) {
  if (b < 1 || s < 1 || h < 1 || g < 1 || h % g != 0 || b > 65535 ||
      h > 65535 || chunk != L || p != P || group != GROUP ||
      states == nullptr || decay == nullptr)
    return int(cudaErrorInvalidValue);
  const int G = ((s + L - 1) / L + GROUP - 1) / GROUP;
  if (G < 2) return int(cudaErrorInvalidValue);
  const SsdArgs a{x, dt, A, B, C, nullptr, states, decay, b, s, h, g, G};
  return dispatch(a, n, dtype, true, static_cast<cudaStream_t>(stream));
}
#endif
