// The gradient of blocked online-softmax attention for Hopper (sm_90a):
// dQ, dK and dV of flash_attention.cu's function, causal, sliding-window
// or bidirectional, grouped-query, float32 or bfloat16 inputs.
//
// The TPU package has no such kernel: its training differentiates
// attention in XLA, outside src/repro/kernels/flash_attention.py:
// _flash_kernel.  The port's forward on the card is the hand-written
// kernel, so its gradient is one too (the autograd function in
// kernels/flash_attention.py launches this after the forward kernel has
// written each row's log-sum-exp).  Layout as the forward: q, dq (B, Sq,
// H, Dh); k, v, dk, dv (B, Sk, KvH, Dh); o, do like q; lse and the
// scratch delta (B, H, Sq) float32; all contiguous.  Query head h reads
// kv head h / (H / KvH).
//
// The FlashAttention-2 recurrence, in three launches:
//   1. delta = rowsum(dO o O) per query row (one warp a row);
//   2. dK / dV: a block owns one (batch, kv head, kv tile) and walks the
//      group's G query heads and the query tiles that can see its keys;
//      per query tile it recomputes P = exp(S scale - lse) (masked
//      entries 0), then dV += P^T dO, dP = dO V^T, dS = P o (dP - delta),
//      dK += dS^T Q; dK is scaled once at the end.  One block sums a kv
//      head's whole gradient, so no atomics, and the result does not
//      depend on the order blocks run in;
//   3. dQ: a block owns one (batch, head, query tile) and walks the kv
//      tiles its rows can see, recomputing P and dS the same way, dQ +=
//      dS K, scaled at the end.
// Tiles are skipped as in the forward: kv tiles above the diagonal and
// before a window's first key; masks (keys >= Sk, rows >= Sq, causal,
// window k > q - window) run per element.  Products, sums and the
// exponential are float32 whatever the inputs' type (bf16 inputs are
// widened as they are staged); dq, dk, dv are rounded to the inputs'
// type once, at the end.
//
// What bounds it: at olmo-1b's training shape (B = 4, S = 2048, H = 16,
// Dh = 128, causal) the function is ~172 GFLOP of products (2.5 x the
// forward's) against ~0.1 GB of traffic, so it is bound by operations.
// Both designs recompute S and dP in launches 2 and 3: seven tile
// products where the function needs five.
//
// bfloat16 at Dh 64, 96 and 128 (flash_bwd_dkdv_tc, flash_bwd_dq_tc):
// mma.sync m16n8k16 bf16 x bf16 -> f32, 4 warps a block, each owning 16
// keys (dK / dV) or 16 query rows (dQ), tiles staged by cp.async,
// fragments by ldmatrix.  S and dP come out of the tensor cores in f32;
// P = exp(S scale - lse) and dS are f32; dV takes bf16(P) as the A
// fragment in registers (the plain version rounds p to v's dtype the same
// way); dK and dQ take dS split into bf16(dS) and bf16(dS - bf16(dS)), two
// products whose sum is float32-accurate, so dS is not rounded where the
// plain version keeps it float32.  At Dh 256 a warp's dK and dV
// accumulators alone would take 256 registers a thread: that width stays
// on the CUDA cores.
//
// float32, and bfloat16 at Dh 256 (flash_bwd_dkdv, flash_bwd_dq): every
// product on the CUDA cores in float32 (64 x 64 tiles, or 64 x 32 at Dh
// 256, staged in shared memory, 4 x 4 register tiles as in the forward's
// float32 path; TF32 would miss the float32 tolerance).  It was the first
// design for bf16 at every width too: 11.7 ms at olmo-1b's B = 4 shape,
// where the tensor-core path takes 1.85 ms (H100 80GB HBM3 at 700 W, in
// turns).

#include <cstdint>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // 16 x 16: thread (ti, tj)
constexpr int BQ = 64;             // query rows of a tile
constexpr int SMEM_OPTIN_BYTES = 232448;   // sm_90: 227 KB a block

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                // (B, H, Sq)
  float* delta;                    // (B, H, Sq), written by launch 1
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KvH;
  int causal, window;              // window < 0: none
  float scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// keys a kv tile holds: 64, or 32 at Dh 256 (its tiles would not fit)
template <int DH>
__host__ __device__ constexpr int bwd_bk() { return DH <= 128 ? 64 : 32; }

// shared memory floats of launches 2 and 3: K, V, Q, dO tiles (row stride
// DH + 4), P and dS tiles (row stride BK + 16), lse and delta of the tile
template <int DH>
__host__ __device__ constexpr int bwd_smem_floats() {
  return 2 * bwd_bk<DH>() * (DH + 4) + 2 * BQ * (DH + 4)
       + 2 * BQ * (bwd_bk<DH>() + 16) + 2 * BQ;
}

// rows [r0, r0 + ROWS) of head `hd` of a (B, S, heads, DH) tensor into
// float32 smem rows of stride DH + 4; rows >= S are zeros
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int S,
                                      int heads, int hd, int r0) {
  for (int idx = threadIdx.x; idx < ROWS * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH, t = r0 + r;
    dst[r * (DH + 4) + d] =
        t < S ? widen(src[((size_t(b) * S + t) * heads + hd) * DH + d]) : 0.f;
  }
}

// rows ti + 16 r (r < 4) of `a` dotted with rows tj + 16 c (c < NC) of
// `b`, both float32 smem tiles of row stride DH + 4
template <int DH, int NC>
__device__ __forceinline__ void tile_dots(float out[4][NC], const float* a,
                                          const float* b, int ti, int tj) {
  constexpr int DS = DH + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) out[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 av[4], bv[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(&a[(ti + 16 * r) * DS + d]);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      bv[c] = *reinterpret_cast<const float4*>(&b[(tj + 16 * c) * DS + d]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float t = out[r][c];
        t = fmaf(av[r].x, bv[c].x, t);
        t = fmaf(av[r].y, bv[c].y, t);
        t = fmaf(av[r].z, bv[c].z, t);
        t = fmaf(av[r].w, bv[c].w, t);
        out[r][c] = t;
      }
  }
}

// acc[i][.] += sum_j w[j][row_i] * x[j][cols]: rows row_i = ti + 16 i
// (i < NR) of a weight tile read transposed (w is J x stride WS, row i at
// column ti + 16 i) or straight (TRANS false: w row ti + 16 i, column j),
// against J rows of a float32 tile x of row stride DH + 4; this thread's
// output columns are GW g + CW tj + e (groups of GW = 64 columns, CW = 4
// a thread, or GW = 32, CW = 2 where 64 does not divide DH)
template <int DH, int NR, int J, int WS, bool TRANS>
__device__ __forceinline__ void tile_accum(float (*acc)[DH / 16],
                                           const float* w, const float* x,
                                           int ti, int tj) {
  constexpr int DS = DH + 4;
  constexpr int GW = DH % 64 == 0 ? 64 : 32;
  constexpr int CW = GW / 16;
  constexpr int NG = DH / GW;
#pragma unroll 2
  for (int j = 0; j < J; ++j) {
    float wv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      wv[i] = TRANS ? w[j * WS + ti + 16 * i] : w[(ti + 16 * i) * WS + j];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float* xp = &x[j * DS + GW * g + CW * tj];
      float xv[CW];
      if constexpr (CW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(xp);
        xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(xp);
        xv[0] = t.x; xv[1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int e = 0; e < CW; ++e)
          acc[i][CW * g + e] = fmaf(wv[i], xv[e], acc[i][CW * g + e]);
    }
  }
}

// write rows ti + 16 i (i < NR) of acc x mult to rows r0 + ti + 16 i < S
// of head `hd` of a (B, S, heads, DH) tensor
template <typename T, int DH, int NR>
__device__ __forceinline__ void store_rows(T* dst, float (*acc)[DH / 16],
                                           float mult, int b, int S, int heads,
                                           int hd, int r0, int ti, int tj) {
  constexpr int GW = DH % 64 == 0 ? 64 : 32;
  constexpr int CW = GW / 16;
  constexpr int NG = DH / GW;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int t = r0 + ti + 16 * i;
    if (t >= S) continue;
    T* row = dst + ((size_t(b) * S + t) * heads + hd) * DH;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < CW; ++e)
        narrow(&row[GW * g + CW * tj + e], acc[i][CW * g + e] * mult);
  }
}

// P and dS of a (BQ x BK) tile from its scores s and dO.V^T products dp
// (rows ti + 16 r, columns tj + 16 c), masked entries 0
template <int NC>
__device__ __forceinline__ void p_and_ds(float s[4][NC], float dp[4][NC],
                                         const BwdArgs& a, const float* lse_s,
                                         const float* del_s, int q0, int k0,
                                         int ti, int tj) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ti + 16 * r, qi = q0 + row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int kj = k0 + tj + 16 * c;
      bool ok = qi < a.Sq && kj < a.Sk;
      if (a.causal) ok = ok && kj <= qi;
      if (a.window >= 0) ok = ok && kj > qi - a.window;
      const float p = ok ? expf(s[r][c] * a.scale - lse_s[row]) : 0.f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - del_s[row]);
    }
  }
}

// launch 1: delta = rowsum(dO o O), one warp a (b, q row, head)
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta(BwdArgs a, int dh) {
  const int lane = threadIdx.x % 32;
  const size_t rowid = size_t(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (rowid >= size_t(a.B) * a.Sq * a.H) return;
  const T* o = static_cast<const T*>(a.o) + rowid * dh;
  const T* d = static_cast<const T*>(a.dout) + rowid * dh;
  float sum = 0.f;
  for (int c = lane; c < dh; c += 32) sum = fmaf(widen(d[c]), widen(o[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = int(rowid % a.H);
    const size_t bq = rowid / a.H;          // b * Sq + qi
    const int qi = int(bq % a.Sq), b = int(bq / a.Sq);
    a.delta[(size_t(b) * a.H + h) * a.Sq + qi] = sum;
  }
}

// launch 2: dK and dV of one (kv tile, kv head, batch)
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv(BwdArgs a) {
  constexpr int BK = bwd_bk<DH>(), NC = BK / 16, NR = BK / 16;
  constexpr int DS = DH + 4, PS = BK + 16;
  static_assert(DH % 32 == 0 && DH > 0,
                "flash bwd: every column must belong to a group of 16 "
                "threads x CW columns");
  static_assert(bwd_smem_floats<DH>() * 4 <= SMEM_OPTIN_BYTES,
                "flash bwd: tiles exceed the shared memory of a block");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * DS;
  float* qs = vs + BK * DS;
  float* dos = qs + BQ * DS;
  float* ps = dos + BQ * DS;
  float* dss = ps + BQ * PS;
  float* lse_s = dss + BQ * PS;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KvH;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);

  stage<T, DH, BK>(ks, static_cast<const T*>(a.k), b, a.Sk, a.KvH, kvh, k0);
  stage<T, DH, BK>(vs, static_cast<const T*>(a.v), b, a.Sk, a.KvH, kvh, k0);

  // query tiles whose rows see a key of this tile
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int k_last = min(k0 + BK, a.Sk) - 1;
  const int qt_begin = a.causal ? min(nq, k0 / BQ) : 0;
  int qt_end = nq;
  if (a.window >= 0)
    qt_end = max(0, min(nq, (k_last + a.window - 1) / BQ + 1));

  float dk[NR][DH / 16], dv[NR][DH / 16];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int e = 0; e < DH / 16; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();             // the previous tile's readers are done
      stage<T, DH, BQ>(qs, q, b, a.Sq, a.H, h, q0);
      stage<T, DH, BQ>(dos, dout, b, a.Sq, a.H, h, q0);
      if (tid < BQ) {
        const int qi = q0 + tid;
        const size_t at = (size_t(b) * a.H + h) * a.Sq + qi;
        lse_s[tid] = qi < a.Sq ? a.lse[at] : 0.f;
        del_s[tid] = qi < a.Sq ? a.delta[at] : 0.f;
      }
      __syncthreads();

      float s[4][NC], dp[4][NC];
      tile_dots<DH, NC>(s, qs, ks, ti, tj);     // S = Q K^T
      tile_dots<DH, NC>(dp, dos, vs, ti, tj);   // dP = dO V^T
      p_and_ds<NC>(s, dp, a, lse_s, del_s, q0, k0, ti, tj);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ps[(ti + 16 * r) * PS + tj + 16 * c] = s[r][c];
          dss[(ti + 16 * r) * PS + tj + 16 * c] = dp[r][c];
        }
      __syncthreads();

      tile_accum<DH, NR, BQ, PS, true>(dv, ps, dos, ti, tj);   // dV += P^T dO
      tile_accum<DH, NR, BQ, PS, true>(dk, dss, qs, ti, tj);   // dK += dS^T Q
    }
  }
  store_rows<T, DH, NR>(static_cast<T*>(a.dk), dk, a.scale, b, a.Sk, a.KvH,
                        kvh, k0, ti, tj);
  store_rows<T, DH, NR>(static_cast<T*>(a.dv), dv, 1.f, b, a.Sk, a.KvH, kvh,
                        k0, ti, tj);
}

// launch 3: dQ of one (query tile, head, batch)
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq(BwdArgs a) {
  constexpr int BK = bwd_bk<DH>(), NC = BK / 16;
  constexpr int DS = DH + 4, PS = BK + 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * DS;
  float* qs = vs + BK * DS;
  float* dos = qs + BQ * DS;
  float* dss = dos + BQ * DS;
  float* lse_s = dss + BQ * PS;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KvH);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  stage<T, DH, BQ>(qs, static_cast<const T*>(a.q), b, a.Sq, a.H, h, q0);
  stage<T, DH, BQ>(dos, static_cast<const T*>(a.dout), b, a.Sq, a.H, h, q0);
  if (tid < BQ) {
    const int qi = q0 + tid;
    const size_t at = (size_t(b) * a.H + h) * a.Sq + qi;
    lse_s[tid] = qi < a.Sq ? a.lse[at] : 0.f;
    del_s[tid] = qi < a.Sq ? a.delta[at] : 0.f;
  }

  // kv tiles this tile's rows see: up to the diagonal, from the window
  int kt_end = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (a.window >= 0) kt_begin = max(0, (q0 - a.window + 1) / BK);

  float dq[4][DH / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < DH / 16; ++e) dq[r][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // the previous tile's readers are done
    stage<T, DH, BK>(ks, k, b, a.Sk, a.KvH, kvh, k0);
    stage<T, DH, BK>(vs, v, b, a.Sk, a.KvH, kvh, k0);
    __syncthreads();

    float s[4][NC], dp[4][NC];
    tile_dots<DH, NC>(s, qs, ks, ti, tj);       // S = Q K^T
    tile_dots<DH, NC>(dp, dos, vs, ti, tj);     // dP = dO V^T
    p_and_ds<NC>(s, dp, a, lse_s, del_s, q0, k0, ti, tj);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        dss[(ti + 16 * r) * PS + tj + 16 * c] = dp[r][c];
    __syncthreads();

    tile_accum<DH, 4, BK, PS, false>(dq, dss, ks, ti, tj);    // dQ += dS K
  }
  store_rows<T, DH, 4>(static_cast<T*>(a.dq), dq, a.scale, b, a.Sq, a.H, h,
                       q0, ti, tj);
}

template <typename T, int DH>
int launch_bwd(const BwdArgs& a, int dh, cudaStream_t s) {
  constexpr int BK = bwd_bk<DH>();
  const size_t rows = size_t(a.B) * a.Sq * a.H;
  flash_bwd_delta<T><<<unsigned((rows + 7) / 8), THREADS, 0, s>>>(a, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int bytes = bwd_smem_floats<DH>() * int(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_kv((a.Sk + BK - 1) / BK, a.KvH, a.B);
  flash_bwd_dkdv<T, DH><<<grid_kv, THREADS, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  // launch 3 has no P tile
  const int bytes_q = bytes - BQ * (BK + 16) * int(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dq<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes_q);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_q((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq<T, DH><<<grid_q, THREADS, bytes_q, s>>>(a);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (mma.sync m16n8k16), Dh 64 / 96 / 128
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;  // keys (dK / dV) or query rows (dQ) a block owns
constexpr int TC_BQ = 32;               // query rows a dK / dV step walks
constexpr int TC_BK = 64;               // keys a dQ step walks

template <int DH>
__host__ __device__ constexpr int tc_dkdv_bytes() {
  return (2 * TC_ROWS + 2 * TC_BQ) * (DH + 8) * 2 + 2 * TC_BQ * 4;
}
template <int DH>
__host__ __device__ constexpr int tc_dq_bytes() {
  return (2 * TC_ROWS + 2 * TC_BK) * (DH + 8) * 2 + 2 * TC_ROWS * 4;
}

// the forward's helpers (csrc/flash_attention.cu), repeated: each source
// builds alone
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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
// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + ROWS) of head `hd` of a (B, S, heads, DH) bf16 tensor
// into smem rows of stride DH + 8 by cp.async; rows >= S are zeros
template <int DH, int ROWS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int b,
                                           int S, int heads, int hd, int r0) {
  constexpr int CH = DH / 8;       // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += TC_THREADS) {
    const int r = idx / CH, c = idx % CH, t = r0 + r;
    const bool in = t < S;
    const __nv_bfloat16* g =
        src + ((size_t(b) * S + (in ? t : 0)) * heads + hd) * DH + 8 * c;
    cp_async16(dst + r * (DH + 8) + 8 * c, g, in ? 16 : 0);
  }
}

// the A fragment (16 x 16) of rows r0.. at k-step kk of a row-major tile
template <int DS>
__device__ __forceinline__ void frag_a(uint32_t f[4],
                                       const __nv_bfloat16* t, int r0,
                                       int kk, int lane) {
  ldmatrix_x4(f, t + (r0 + (lane & 15)) * DS + 16 * kk + 8 * (lane >> 4));
}
// the B fragments of n-tiles j, j + 1 at k-step kk, the tile's rows the n
// index and its columns the k index (a tile read as its transpose)
template <int DS>
__device__ __forceinline__ void frag_b_rows(uint32_t f[4],
                                            const __nv_bfloat16* t, int j,
                                            int kk, int lane) {
  ldmatrix_x4(f, t + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * DS
                   + 16 * kk + 8 * ((lane >> 3) & 1));
}
// the B fragments of n-tiles j, j + 1 at k-step kk, the tile's rows the k
// index and its columns the n index
template <int DS>
__device__ __forceinline__ void frag_b_cols(uint32_t f[4],
                                            const __nv_bfloat16* t, int j,
                                            int kk, int lane) {
  ldmatrix_x4_trans(f, t + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * DS
                         + 8 * j + 8 * (lane >> 4));
}
// accumulator n-tiles c0, c1 (16 columns) as an A fragment in bf16, and
// its remainder x - bf16(x) as a second: the two products sum to a
// float32-accurate one
__device__ __forceinline__ void split_a(uint32_t hi[4], uint32_t lo[4],
                                        const float c0[4], const float c1[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
  float r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r[i] = x[i] - __bfloat162float(__float2bfloat16_rn(x[i]));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
    lo[i] = pack_bf16(r[2 * i], r[2 * i + 1]);
  }
}

__device__ __forceinline__ bool seen(const BwdArgs& a, int qi, int kj) {
  bool ok = qi < a.Sq && kj < a.Sk;
  if (a.causal) ok = ok && kj <= qi;
  if (a.window >= 0) ok = ok && kj > qi - a.window;
  return ok;
}

// dK and dV of one (64-key tile, kv head, batch): warp w owns keys 16 w ..
// 16 w + 15 and walks the group's query heads in steps of TC_BQ rows:
// S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T scale - lse), dS^T = P^T o
// (dP^T - delta), dV += bf16(P^T) dO, dK += dS^T Q with dS^T split in
// two bf16 parts
template <int DH>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dkdv_tc(BwdArgs a) {
  constexpr int DS = DH + 8, KS = DH / 16, NQ = TC_BQ / 8, ND = DH / 8;
  static_assert(DH % 16 == 0 && ND % 2 == 0,
                "flash bwd tc: Dh must be whole 16-wide k-steps");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* vs = ks + TC_ROWS * DS;
  __nv_bfloat16* qs = vs + TC_ROWS * DS;
  __nv_bfloat16* dos = qs + TC_BQ * DS;
  float* lse_s = reinterpret_cast<float*>(dos + TC_BQ * DS);
  float* del_s = lse_s + TC_BQ;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * TC_ROWS, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KvH;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);
  stage_bf16<DH, TC_ROWS>(ks, static_cast<const __nv_bfloat16*>(a.k), b,
                          a.Sk, a.KvH, kvh, k0);
  stage_bf16<DH, TC_ROWS>(vs, static_cast<const __nv_bfloat16*>(a.v), b,
                          a.Sk, a.KvH, kvh, k0);
  cp_async_commit();

  const int nq = (a.Sq + TC_BQ - 1) / TC_BQ;
  const int k_last = min(k0 + TC_ROWS, a.Sk) - 1;
  const int qt_begin = a.causal ? min(nq, k0 / TC_BQ) : 0;
  int qt_end = nq;
  if (a.window >= 0)
    qt_end = max(0, min(nq, (k_last + a.window - 1) / TC_BQ + 1));
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int gq = 0; gq < G; ++gq) {
    const int h = kvh * G + gq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * TC_BQ;
      __syncthreads();             // the previous step's readers are done
      stage_bf16<DH, TC_BQ>(qs, q, b, a.Sq, a.H, h, q0);
      stage_bf16<DH, TC_BQ>(dos, dout, b, a.Sq, a.H, h, q0);
      cp_async_commit();
      if (threadIdx.x < TC_BQ) {
        const int qi = q0 + threadIdx.x;
        const size_t at = (size_t(b) * a.H + h) * a.Sq + qi;
        lse_s[threadIdx.x] = qi < a.Sq ? a.lse[at] : 0.f;
        del_s[threadIdx.x] = qi < a.Sq ? a.delta[at] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[4], vf[4];
        frag_a<DS>(kf, ks, 16 * warp, kk, lane);
        frag_a<DS>(vf, vs, 16 * warp, kk, lane);
#pragma unroll
        for (int j = 0; j < NQ; j += 2) {
          uint32_t qb[4], db[4];
          frag_b_rows<DS>(qb, qs, j, kk, lane);
          frag_b_rows<DS>(db, dos, j, kk, lane);
          mma_bf16(st[j], kf, qb[0], qb[1]);
          mma_bf16(st[j + 1], kf, qb[2], qb[3]);
          mma_bf16(dpt[j], vf, db[0], db[1]);
          mma_bf16(dpt[j + 1], vf, db[2], db[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t4 + (e & 1);
          const float p = seen(a, q0 + qc, e < 2 ? key0 : key1)
              ? expf(st[j][e] * a.scale - lse_s[qc]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - del_s[qc]);
        }
#pragma unroll
      for (int kk = 0; kk < TC_BQ / 16; ++kk) {
        uint32_t pa[4], sh[4], sl[4];
        pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        split_a(sh, sl, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          uint32_t db[4], qb[4];
          frag_b_cols<DS>(db, dos, j, kk, lane);
          frag_b_cols<DS>(qb, qs, j, kk, lane);
          mma_bf16(dv[j], pa, db[0], db[1]);
          mma_bf16(dv[j + 1], pa, db[2], db[3]);
          mma_bf16(dk[j], sh, qb[0], qb[1]);
          mma_bf16(dk[j + 1], sh, qb[2], qb[3]);
          mma_bf16(dk[j], sl, qb[0], qb[1]);
          mma_bf16(dk[j + 1], sl, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait_all();             // nothing in flight at exit
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key1 : key0;
    if (key >= a.Sk) continue;
    const size_t at = ((size_t(b) * a.Sk + key) * a.KvH + kvh) * DH;
    __nv_bfloat16* dkr = static_cast<__nv_bfloat16*>(a.dk) + at;
    __nv_bfloat16* dvr = static_cast<__nv_bfloat16*>(a.dv) + at;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * j + 2 * t4) =
          pack_bf16(dk[j][2 * r] * a.scale, dk[j][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * j + 2 * t4) =
          pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// dQ of one (64-row query tile, head, batch): warp w owns rows 16 w ..
// 16 w + 15 and walks the kv tiles they see, TC_BK keys a step:
// S = Q K^T, dP = dO V^T, P, dS as above, dQ += dS K with dS split in two
// bf16 parts
template <int DH>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_tc(BwdArgs a) {
  constexpr int DS = DH + 8, KS = DH / 16, NK = TC_BK / 8, ND = DH / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* dos = qs + TC_ROWS * DS;
  __nv_bfloat16* ks = dos + TC_ROWS * DS;
  __nv_bfloat16* vs = ks + TC_BK * DS;
  float* lse_s = reinterpret_cast<float*>(vs + TC_BK * DS);
  float* del_s = lse_s + TC_ROWS;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * TC_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KvH);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  stage_bf16<DH, TC_ROWS>(qs, static_cast<const __nv_bfloat16*>(a.q), b,
                          a.Sq, a.H, h, q0);
  stage_bf16<DH, TC_ROWS>(dos, static_cast<const __nv_bfloat16*>(a.dout), b,
                          a.Sq, a.H, h, q0);
  cp_async_commit();
  if (threadIdx.x < TC_ROWS) {
    const int qi = q0 + threadIdx.x;
    const size_t at = (size_t(b) * a.H + h) * a.Sq + qi;
    lse_s[threadIdx.x] = qi < a.Sq ? a.lse[at] : 0.f;
    del_s[threadIdx.x] = qi < a.Sq ? a.delta[at] : 0.f;
  }

  int kt_end = (a.Sk + TC_BK - 1) / TC_BK;
  if (a.causal) kt_end = min(kt_end, (q0 + TC_ROWS - 1) / TC_BK + 1);
  int kt_begin = 0;
  if (a.window >= 0) kt_begin = max(0, (q0 - a.window + 1) / TC_BK);
  const int r0 = 16 * warp + g, r1 = r0 + 8;      // this thread's two rows

  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * TC_BK;
    __syncthreads();               // the previous step's readers are done
    stage_bf16<DH, TC_BK>(ks, k, b, a.Sk, a.KvH, kvh, k0);
    stage_bf16<DH, TC_BK>(vs, v, b, a.Sk, a.KvH, kvh, k0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4], df[4];
      frag_a<DS>(qf, qs, 16 * warp, kk, lane);
      frag_a<DS>(df, dos, 16 * warp, kk, lane);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t kb[4], vb[4];
        frag_b_rows<DS>(kb, ks, j, kk, lane);
        frag_b_rows<DS>(vb, vs, j, kk, lane);
        mma_bf16(s[j], qf, kb[0], kb[1]);
        mma_bf16(s[j + 1], qf, kb[2], kb[3]);
        mma_bf16(dp[j], df, vb[0], vb[1]);
        mma_bf16(dp[j + 1], df, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1;
        const float p = seen(a, q0 + r, k0 + 8 * j + 2 * t4 + (e & 1))
            ? expf(s[j][e] * a.scale - lse_s[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - del_s[r]);
      }
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      split_a(sh, sl, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t kb[4];
        frag_b_cols<DS>(kb, ks, j, kk, lane);
        mma_bf16(dq[j], sh, kb[0], kb[1]);
        mma_bf16(dq[j + 1], sh, kb[2], kb[3]);
        mma_bf16(dq[j], sl, kb[0], kb[1]);
        mma_bf16(dq[j + 1], sl, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait_all();             // nothing in flight at exit
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + (r ? r1 : r0);
    if (qi >= a.Sq) continue;
    __nv_bfloat16* row = static_cast<__nv_bfloat16*>(a.dq)
        + ((size_t(b) * a.Sq + qi) * a.H + h) * DH;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
  }
}

template <int DH>
int launch_bwd_tc(const BwdArgs& a, int dh, cudaStream_t s) {
  const size_t rows = size_t(a.B) * a.Sq * a.H;
  flash_bwd_delta<__nv_bfloat16><<<unsigned((rows + 7) / 8), THREADS, 0, s>>>(
      a, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tc_dkdv_bytes<DH>());
  if (err != cudaSuccess) return int(err);
  const dim3 grid_kv((a.Sk + TC_ROWS - 1) / TC_ROWS, a.KvH, a.B);
  flash_bwd_dkdv_tc<DH><<<grid_kv, TC_THREADS, tc_dkdv_bytes<DH>(), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_tc<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tc_dq_bytes<DH>());
  if (err != cudaSuccess) return int(err);
  const dim3 grid_q((a.Sq + TC_ROWS - 1) / TC_ROWS, a.H, a.B);
  flash_bwd_dq_tc<DH><<<grid_q, TC_THREADS, tc_dq_bytes<DH>(), s>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dtype(const BwdArgs& a, int dh, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    switch (dh) {                  // Dh 256 stays on the CUDA cores
      case 64: return launch_bwd_tc<64>(a, dh, s);
      case 96: return launch_bwd_tc<96>(a, dh, s);
      case 128: return launch_bwd_tc<128>(a, dh, s);
      case 256: return launch_bwd<T, 256>(a, dh, s);
    }
  } else {
    switch (dh) {
      case 64: return launch_bwd<T, 64>(a, dh, s);
      case 96: return launch_bwd<T, 96>(a, dh, s);
      case 128: return launch_bwd<T, 128>(a, dh, s);
      case 256: return launch_bwd<T, 256>(a, dh, s);
    }
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv all of it; lse and delta
// float32).  dk / dv are written whole (zeros where no query sees a key).
// Three launches on `stream`, no synchronisation, no allocation; returns
// a CUDA error code (0 = success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KvH, int Dh, int causal,
    int window, float scale, int dtype, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 1 || H < 1 || KvH < 1 || H % KvH != 0 ||
      B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, H, KvH,
                  causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(a, Dh, s);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(a, Dh, s);
  return int(cudaErrorInvalidValue);
}

#endif
