// The gradient of blocked online-softmax attention for Hopper (sm_90a):
// dQ, dK and dV of flash_attention.cu's function, causal, sliding-window
// or bidirectional, grouped-query, float32 or bfloat16 inputs.
//
// A narrower head arrives zero-padded, with its dO and O padded likewise,
// from the wrapper (kernels/flash_attention.py), as in the forward.
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
// The FlashAttention-2 recurrence: delta = rowsum(dO o O) per query row
// (one warp a row, its own launch); then per (query tile, kv tile) P =
// exp(S scale - lse) (masked entries 0), dV += P^T dO, dP = dO V^T, dS =
// P o (dP - delta), dK += dS^T Q, dQ += dS K; dK and dQ are scaled once
// at the end.  A block that sums dK / dV owns a kv tile and walks the
// group's G query heads and the query tiles that see its keys; a block
// that sums dQ owns a query tile and walks the kv tiles its rows see.
// Each sum is one block's, in a fixed order: no atomics, and a run
// repeats bit for bit.  Tiles no row of which sees a key are skipped;
// masks (keys >= Sk, rows >= Sq, causal, window k > q - window) run per
// element only in tiles that straddle one.
//
// What bounds it: at olmo-1b's training shape (B = 4, S = 2048, H = 16,
// Dh = 128, causal) the function is ~172 GFLOP of products (2.5 x the
// forward's) against ~0.1 GB of traffic, so it is bound by operations.
//
// bfloat16, every Dh (flash_bwd_hb: launch 2 holds the dK / dV blocks and
// then the dQ blocks in one grid, so dQ blocks fill the SMs a causal
// call's short dK / dV blocks leave).  A block owns 64 rows (keys, or
// query rows) and walks 64-row steps (query tiles, or kv tiles).  Every
// product is a wgmma chain (m64nNk16, bf16 in, float32 sums):
//   - S^T = K Q^T and dP^T = V dO^T (S and dP in a dQ block): both
//     operands K-major tiles in shared memory, computed once a step;
//   - dV += P^T dO, dK += dS^T Q (dQ += dS K): A is P^T or dS^T as bf16
//     register fragments, packed from the S^T / dP^T accumulators as they
//     lie (a warp's 16 rows), B the step's tile read MN-major (these
//     products contract over the tiles' rows).  On mma.sync with B by
//     ldmatrix.trans they took 5-15 % longer, and S and dP 12-19 %
//     (H100, in turns: PERF.md);
//   - Dh <= 128: one warpgroup a block, two blocks an SM (two warpgroups
//     sharing a block's tiles were 2-6 % slower: a block-wide barrier each
//     step kept them in lockstep, so neither hid the other's wait on its
//     wgmma).  P^T and dS^T stay in registers; a thread holds Dh / 2
//     floats each of dK and dV;
//   - Dh 256: two warpgroups split Dh, so a thread holds 128 floats of
//     dK and dV (FlashAttention-2's head-dim-256 layout).  Warpgroup 0
//     computes S^T and P^T, warpgroup 1 dP^T and, reading P^T as float32,
//     dS^T; they share P^T and dS^T as bf16 fragments through shared
//     memory (48 words a thread, in fragment order: no bank conflicts);
//   - tiles live in shared memory in the 128-byte swizzle (16-byte chunk
//     c of row r at c ^ (r % 8)), which wgmma reads either way (K-major
//     or MN-major) and cp.async fills 16 bytes a thread; Q, dO, lse and
//     delta (K and V in a dQ block) sit in a ring of two stages, the next
//     step's copies issued before this step's products;
//   - dS is rounded once to bf16 for both of its products, not split
//     into two bf16 parts, and P once for dV, as
//     flash_attention_bwd_plain rounds them; S and dP are still computed
//     again by the dQ blocks, which keeps every sum in one block: seven
//     tile products where the function needs five.  P = 2^((S scale -
//     lse) log2 e) by ex2.approx.
// Shared memory at Dh 256: K, V 64 KB, two stages of Q, dO 128 KB, lse
// and delta 1 KB, the exchange 24 KB: 218 KB of the 227 a block may have.
//
// float32 (flash_bwd_dkdv, flash_bwd_dq): every product on the CUDA
// cores in float32 (64 x 64 tiles, or 64 x 32 at Dh 256, staged in
// shared memory, 4 x 4 register tiles as in the forward's float32 path;
// TF32 would miss the float32 tolerance), launch 2 dK / dV and launch 3
// dQ, each recomputing S and dP.

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
// bfloat16 on the tensor cores, every Dh
// ---------------------------------------------------------------------------

constexpr int HB_TILE = 64;   // rows a block owns, of a tile and of a step
constexpr float LOG2E = 1.4426950408889634f;

// Dh 256: two warpgroups split Dh between them; Dh <= 128: one
// warpgroup a block, two blocks an SM
template <int DH>
__host__ __device__ constexpr bool hb_split() { return DH > 128; }
template <int DH>
__host__ __device__ constexpr int hb_threads() {
  return hb_split<DH>() ? 256 : 128;
}
// bytes of one 64-row bf16 tile: ceil(DH / 64) column blocks of 64 rows x
// 128 bytes, each in the 128-byte swizzle wgmma and TMA read (16-byte
// chunk c of row r at chunk c ^ (r % 8) of its 128-byte line)
template <int DH>
__host__ __device__ constexpr int hb_tile_bytes() {
  return (DH + 63) / 64 * HB_TILE * 128;
}
// shared memory of a block: two fixed tiles, two stages of two streamed
// tiles, two stages of 64 rows' lse and delta, with Dh split the exchange
// of P and dS (48 words a thread of a warpgroup), 1024 bytes to align
template <int DH>
__host__ __device__ constexpr int hb_smem_bytes() {
  return 6 * hb_tile_bytes<DH>() + 2 * 2 * HB_TILE * 4
       + (hb_split<DH>() ? 48 * 128 * 4 : 0) + 1024;
}

// byte offset of 16-byte chunk c of row r in a 64-row swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (HB_TILE * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
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
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// copies made by the threads (cp.async) visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma's shared-memory matrix descriptor of a K-major tile in the
// 128-byte swizzle: start address, leading offset 16 bytes (unused in
// this swizzle), 1024 bytes between 8-row groups, swizzle mode 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16)
       | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// d (64 x 64 f32, the warpgroup's) = [d +] a (64 x 16) . b (64 x 16)^T,
// both bf16 in shared memory
__device__ __forceinline__ void wgmma_64x64(float d[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x N f32, the warpgroup's) += a (64 x 16 bf16, each thread's
// register fragment) . b (16 x N), b an MN-major tile in shared memory
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t a[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t a[4],
                                              uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t a[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t a[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// wgmma's descriptor of an MN-major tile in the 128-byte swizzle (the B
// operand of a product that contracts over the tile's rows): 8192 bytes
// between 64-column blocks, 1024 between 8-row groups
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(8192 >> 4) << 16)
       | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// keeps the compiler from moving a use of d across the wgmma's issue or
// wait
template <int N = 32>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a . b^T over DH for the warpgroup: a and b 64-row K-major tiles, d
// its 64 x 64 products in the m16n8 accumulator layout (warp w rows 16 w
// .. 16 w + 15; n-tile j, element e at d[4 j + e]: row g + 8 (e / 2),
// column 8 j + 2 t4 + e % 2).  Issues one wgmma chain, committed as a
// group (wait for it with wg_wait)
template <int DH>
__device__ __forceinline__ void wg_issue(float d[32], const unsigned char* a,
                                         const unsigned char* b) {
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int off = (kk >> 2) * (HB_TILE * 128) + (kk & 3) * 32;
    wgmma_64x64(d, sw128_desc(a + off), sw128_desc(b + off), kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// d (the warpgroup's 64 x N f32) += a (64 x 64 bf16, four k-steps of
// register fragments) . b (64 rows x N columns from chunk c0 of an
// MN-major tile in shared memory): one register-A wgmma chain, committed
// as a group
template <int N>
__device__ __forceinline__ void wg_accumulate(float* d, const uint32_t a[4][4],
                                              const unsigned char* b, int c0) {
  fence_acc<N / 2>(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<N>(d, a[kk], mn_desc(b + (c0 >> 3) * (HB_TILE * 128)
                                  + kk * 16 * 128));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// the issued chains done, their accumulators d0 (N / 2 floats a thread;
// and d1) ready
template <int N>
__device__ __forceinline__ void wg_wait(float* d0, float* d1) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc<N / 2>(d0);
  if (d1 != nullptr) fence_acc<N / 2>(d1);
}

// 2^x by the SFU's approximation (relative error ~2^-22; results below
// 2^-126 flush to 0).  P is rounded to bf16 for its product and dS after
// one more multiply, so the approximation does not show in the
// gradients; exp2f made the kernel 5-18 % slower (H100, in turns)
__device__ __forceinline__ float hb_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// accumulator n-tiles 2 kk and 2 kk + 1 as the bf16 A fragment of k-step
// kk
__device__ __forceinline__ void frag_a_acc(uint32_t f[4], const float d[32],
                                           int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    f[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// rows [r0, r0 + 64) of head `hd` of a (B, S, heads, DH) bf16 tensor into
// a swizzled tile by cp.async; rows >= S are zeros
template <int DH>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const void* src,
                                           int b, int S, int heads, int hd,
                                           int r0) {
  constexpr int CH = DH / 8;       // 16-byte chunks a row
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(src);
  for (int idx = threadIdx.x; idx < HB_TILE * CH; idx += hb_threads<DH>()) {
    const int r = idx / CH, c = idx % CH, t = r0 + r;
    const bool in = t < S;
    const __nv_bfloat16* g =
        base + ((size_t(b) * S + (in ? t : 0)) * heads + hd) * DH + 8 * c;
    cp_async16(dst + swz(r, c), g, in ? 16 : 0);
  }
}
// rows [q0, q0 + 64) of head h of lse, then of delta, into rows[0, 128)
__device__ __forceinline__ void stage_rows(float* rows, const BwdArgs& a,
                                           int b, int h, int q0) {
  if (threadIdx.x < 2 * HB_TILE) {
    const int qi = q0 + threadIdx.x % HB_TILE;
    const float* src = threadIdx.x < HB_TILE ? a.lse : a.delta;
    const bool in = qi < a.Sq;
    cp_async4(rows + threadIdx.x,
              src + (size_t(b) * a.H + h) * a.Sq + (in ? qi : 0), in ? 4 : 0);
  }
}

__device__ __forceinline__ bool seen(const BwdArgs& a, int qi, int kj) {
  bool ok = qi < a.Sq && kj < a.Sk;
  if (a.causal) ok = ok && kj <= qi;
  if (a.window >= 0) ok = ok && kj > qi - a.window;
  return ok;
}
// every (query, key) of the 64-row tiles at q0 and k0 is seen: no mask
__device__ __forceinline__ bool all_seen(const BwdArgs& a, int q0, int k0) {
  return q0 + HB_TILE <= a.Sq && k0 + HB_TILE <= a.Sk &&
         (!a.causal || k0 + HB_TILE - 1 <= q0) &&
         (a.window < 0 || k0 > q0 + HB_TILE - 1 - a.window);
}

// The block's shared memory, 1024-aligned: the fixed tiles of each kind
// (0: K or Q, 1: V or dO), stage st's streamed tiles of each kind, the
// stages' lse / delta rows, and with Dh split the exchange: xp [32][128]
// floats (P, then dS as bf16 pairs in its first 16 rows), xpb [16][128]
// P as bf16 pairs
template <int DH>
struct HbSmem {
  unsigned char* base;
  static constexpr int TB = hb_tile_bytes<DH>();
  __device__ explicit HbSmem(void* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* fixed(int kind) const { return base + kind * TB; }
  __device__ unsigned char* stage(int st, int kind) const {
    return base + (2 + 2 * st + kind) * TB;
  }
  __device__ float* rows(int st) const {
    return reinterpret_cast<float*>(base + 6 * TB) + 2 * HB_TILE * st;
  }
  __device__ float* xp() const { return rows(0) + 4 * HB_TILE; }
  __device__ uint32_t* xpb() const {
    return reinterpret_cast<uint32_t*>(xp() + 32 * 128);
  }
};

// query tiles [begin, end) whose rows see a key of [k0, k0 + 64)
__device__ __forceinline__ void query_tiles(const BwdArgs& a, int k0,
                                            int& begin, int& end) {
  const int nq = (a.Sq + HB_TILE - 1) / HB_TILE;
  const int k_last = min(k0 + HB_TILE, a.Sk) - 1;
  begin = a.causal ? min(nq, k0 / HB_TILE) : 0;
  end = nq;
  if (a.window >= 0)
    end = max(0, min(nq, (k_last + a.window - 1) / HB_TILE + 1));
  end = max(begin, end);
}
// kv tiles [begin, end) a key of which rows [q0, q0 + 64) see
__device__ __forceinline__ void kv_tiles(const BwdArgs& a, int q0, int& begin,
                                         int& end) {
  end = (a.Sk + HB_TILE - 1) / HB_TILE;
  if (a.causal) end = min(end, (q0 + HB_TILE - 1) / HB_TILE + 1);
  begin = 0;
  if (a.window >= 0) begin = max(0, (q0 - a.window + 1) / HB_TILE);
  end = max(begin, end);
}

// dK and dV of one (64-key tile, kv head, batch).  Steps walk the
// group's G query heads and the 64-row query tiles that see a key of the
// tile; the next step's Q, dO, lse and delta are copied while this one
// computes.  Dh split: warpgroup 0 computes S^T = K Q^T and P^T,
// warpgroup 1 dP^T = V dO^T and dS^T from P^T (float32, through xp);
// both then add bf16(P^T) dO and bf16(dS^T) Q into their half of Dh.
// Otherwise the one warpgroup computes S^T and dP^T, keeps P^T and dS^T
// in registers and adds both products over all of Dh.
template <int DH>
__device__ __forceinline__ void hb_dkdv(const BwdArgs& a,
                                        const HbSmem<DH>& sm, int kt,
                                        int kvh, int b) {
  constexpr bool SPLIT = hb_split<DH>();
  constexpr int ND = SPLIT ? DH / 16 : DH / 8;  // n-tiles of 8 a thread sums
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, w = wt / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int k0 = kt * HB_TILE, G = a.H / a.KvH;
  int qt_begin, qt_end;
  query_tiles(a, k0, qt_begin, qt_end);
  const int per_head = qt_end - qt_begin, n_steps = G * per_head;
  auto load_step = [&](int i, int st) {
    const int h = kvh * G + i / per_head;
    const int q0 = (qt_begin + i % per_head) * HB_TILE;
    stage_tile<DH>(sm.stage(st, 0), a.q, b, a.Sq, a.H, h, q0);
    stage_tile<DH>(sm.stage(st, 1), a.dout, b, a.Sq, a.H, h, q0);
    stage_rows(sm.rows(st), a, b, h, q0);
  };
  stage_tile<DH>(sm.fixed(0), a.k, b, a.Sk, a.KvH, kvh, k0);
  stage_tile<DH>(sm.fixed(1), a.v, b, a.Sk, a.KvH, kvh, k0);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int key0 = k0 + 16 * w + g;       // this thread's keys: key0, + 8
  const int c0 = SPLIT ? wg * (DH / 16) : 0;  // first chunk it sums into

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    const int q0 = (qt_begin + i % per_head) * HB_TILE;
    cp_async_wait_all();             // step i's tiles have landed
    fence_proxy_async();
    __syncthreads();                 // ... for every thread; step i - 1 done
    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);
    cp_async_commit();
    const unsigned char* qs = sm.stage(st, 0);
    const unsigned char* dos = sm.stage(st, 1);
    const float* lse_s = sm.rows(st);
    const float* del_s = lse_s + HB_TILE;
    const bool full = all_seen(a, q0, k0);
    uint32_t pa[4][4], sa[4][4];     // bf16 P^T and dS^T, k-steps of 16
    if constexpr (SPLIT) {
      float* xp = sm.xp();
      uint32_t* xpu = reinterpret_cast<uint32_t*>(xp);
      uint32_t* xpb = sm.xpb();
      float acc[32];
      wg_issue<DH>(acc, sm.fixed(wg), sm.stage(st, wg));
      wg_wait<64>(acc, nullptr);
      if (wg == 0) {               // P^T = exp(S^T scale - lse), masked 0
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * t4 + (e & 1);
            const bool ok = full || seen(a, q0 + qc, key0 + 8 * (e >> 1));
            const float p = ok
                ? hb_exp2((acc[4 * j + e] * a.scale - lse_s[qc]) * LOG2E)
                : 0.f;
            acc[4 * j + e] = p;
            xp[(4 * j + e) * 128 + wt] = p;
          }
#pragma unroll
        for (int r = 0; r < 16; ++r)
          xpb[r * 128 + wt] = pack_bf16(acc[2 * r], acc[2 * r + 1]);
      }
      __syncthreads();
      if (wg == 1) {               // dS^T = P^T o (dP^T - delta)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * j + e] = xp[(4 * j + e) * 128 + wt]
                * (acc[4 * j + e] - del_s[8 * j + 2 * t4 + (e & 1)]);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          xpu[r * 128 + wt] = pack_bf16(acc[2 * r], acc[2 * r + 1]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = xpb[(4 * kk + r) * 128 + wt];
          sa[kk][r] = xpu[(4 * kk + r) * 128 + wt];
        }
    } else {
      float s[32], dp[32];
      wg_issue<DH>(s, sm.fixed(0), qs);
      wg_issue<DH>(dp, sm.fixed(1), dos);
      wg_wait<64>(s, dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t4 + (e & 1);
          const bool ok = full || seen(a, q0 + qc, key0 + 8 * (e >> 1));
          const float p = ok
              ? hb_exp2((s[4 * j + e] * a.scale - lse_s[qc]) * LOG2E) : 0.f;
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - del_s[qc]);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        frag_a_acc(pa[kk], s, kk);
        frag_a_acc(sa[kk], dp, kk);
      }
    }
    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q
    wg_accumulate<8 * ND>(&dv[0][0], pa, dos, c0);
    wg_accumulate<8 * ND>(&dk[0][0], sa, qs, c0);
    wg_wait<8 * ND>(&dv[0][0], &dk[0][0]);
  }
  cp_async_wait_all();             // nothing in flight at exit
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.Sk) continue;
    const size_t at = ((size_t(b) * a.Sk + key) * a.KvH + kvh) * DH + 8 * c0;
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

// dQ of one (64-row query tile, head, batch).  Steps walk the 64-key
// tiles the rows see; the next tile's K and V are copied while this one
// computes.  Dh split: warpgroup 0 computes S = Q K^T and P, warpgroup 1
// dP = dO V^T and dS from P; both add bf16(dS) K into their half of Dh.
// Otherwise the one warpgroup computes S, dP, P and dS in registers and
// adds bf16(dS) K over all of Dh.
template <int DH>
__device__ __forceinline__ void hb_dq(const BwdArgs& a, const HbSmem<DH>& sm,
                                      int qt, int h, int b) {
  constexpr bool SPLIT = hb_split<DH>();
  constexpr int ND = SPLIT ? DH / 16 : DH / 8;
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, w = wt / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int q0 = qt * HB_TILE, kvh = h / (a.H / a.KvH);
  int kt_begin, kt_end;
  kv_tiles(a, q0, kt_begin, kt_end);
  auto load_step = [&](int kt, int st) {
    stage_tile<DH>(sm.stage(st, 0), a.k, b, a.Sk, a.KvH, kvh, kt * HB_TILE);
    stage_tile<DH>(sm.stage(st, 1), a.v, b, a.Sk, a.KvH, kvh, kt * HB_TILE);
  };
  stage_tile<DH>(sm.fixed(0), a.q, b, a.Sq, a.H, h, q0);
  stage_tile<DH>(sm.fixed(1), a.dout, b, a.Sq, a.H, h, q0);
  if (kt_begin < kt_end) load_step(kt_begin, 0);
  cp_async_commit();

  // this thread's rows r0 = q0 + 16 w + g and r0 + 8: their lse and delta
  const int r0 = q0 + 16 * w + g;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    const size_t at = (size_t(b) * a.H + h) * a.Sq + qi;
    lse_r[r] = qi < a.Sq ? a.lse[at] : 0.f;
    del_r[r] = qi < a.Sq ? a.delta[at] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const int c0 = SPLIT ? wg * (DH / 16) : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1, k0 = kt * HB_TILE;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < kt_end) load_step(kt + 1, st ^ 1);
    cp_async_commit();
    const unsigned char* ks = sm.stage(st, 0);
    const bool full = all_seen(a, q0, k0);
    uint32_t sa[4][4];               // bf16 dS, k-steps of 16 keys
    if constexpr (SPLIT) {
      float* xp = sm.xp();
      uint32_t* xpu = reinterpret_cast<uint32_t*>(xp);
      float acc[32];
      wg_issue<DH>(acc, sm.fixed(wg), sm.stage(st, wg));
      wg_wait<64>(acc, nullptr);
      if (wg == 0) {               // P = exp(S scale - lse), masked 0
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = full || seen(a, r0 + 8 * (e >> 1),
                                         k0 + 8 * j + 2 * t4 + (e & 1));
            xp[(4 * j + e) * 128 + wt] = ok
                ? hb_exp2((acc[4 * j + e] * a.scale - lse_r[e >> 1]) * LOG2E)
                : 0.f;
          }
      }
      __syncthreads();
      if (wg == 1) {               // dS = P o (dP - delta)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * j + e] = xp[(4 * j + e) * 128 + wt]
                             * (acc[4 * j + e] - del_r[e >> 1]);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          xpu[r * 128 + wt] = pack_bf16(acc[2 * r], acc[2 * r + 1]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) sa[kk][r] = xpu[(4 * kk + r) * 128 + wt];
    } else {
      float s[32], dp[32];
      wg_issue<DH>(s, sm.fixed(0), ks);
      wg_issue<DH>(dp, sm.fixed(1), sm.stage(st, 1));
      wg_wait<64>(s, dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = full || seen(a, r0 + 8 * (e >> 1),
                                       k0 + 8 * j + 2 * t4 + (e & 1));
          const float p = ok
              ? hb_exp2((s[4 * j + e] * a.scale - lse_r[e >> 1]) * LOG2E)
              : 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - del_r[e >> 1]);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_a_acc(sa[kk], dp, kk);
    }
    // dQ += bf16(dS) K
    wg_accumulate<8 * ND>(&dq[0][0], sa, ks, c0);
    wg_wait<8 * ND>(&dq[0][0], nullptr);
  }
  cp_async_wait_all();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= a.Sq) continue;
    __nv_bfloat16* row = static_cast<__nv_bfloat16*>(a.dq)
        + ((size_t(b) * a.Sq + qi) * a.H + h) * DH + 8 * c0;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
  }
}

// launch 2 of the bf16 path: the dK / dV blocks (kv tile slowest, so a
// causal call's longest blocks start first), then the dQ blocks (query
// tile slowest, last tile first) in one grid
template <int DH>
__global__ void __launch_bounds__(hb_threads<DH>(), 256 / hb_threads<DH>())
    flash_bwd_hb(BwdArgs a) {
  static_assert(DH % 32 == 0 && DH <= 256,
                "flash bwd hb: a warpgroup's n-tiles must come in pairs");
  static_assert(hb_smem_bytes<DH>() <= SMEM_OPTIN_BYTES,
                "flash bwd hb: tiles exceed the shared memory of a block");
  extern __shared__ float4 smem4[];
  const HbSmem<DH> sm(smem4);
  const int n_kv = (a.Sk + HB_TILE - 1) / HB_TILE * a.KvH * a.B;
  const int id = blockIdx.x;
  if (id < n_kv) {
    const int kt = id / (a.KvH * a.B), rest = id % (a.KvH * a.B);
    hb_dkdv<DH>(a, sm, kt, rest % a.KvH, rest / a.KvH);
  } else {
    const int j = id - n_kv, nq = (a.Sq + HB_TILE - 1) / HB_TILE;
    const int qt = nq - 1 - j / (a.H * a.B), rest = j % (a.H * a.B);
    hb_dq<DH>(a, sm, qt, rest % a.H, rest / a.H);
  }
}

template <int DH>
int launch_bwd_hb(const BwdArgs& a, int dh, cudaStream_t s) {
  const size_t rows = size_t(a.B) * a.Sq * a.H;
  flash_bwd_delta<__nv_bfloat16><<<unsigned((rows + 7) / 8), THREADS, 0, s>>>(
      a, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(flash_bwd_hb<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             hb_smem_bytes<DH>());
  if (err != cudaSuccess) return int(err);
  const size_t blocks = size_t((a.Sk + HB_TILE - 1) / HB_TILE) * a.KvH * a.B +
                        size_t((a.Sq + HB_TILE - 1) / HB_TILE) * a.H * a.B;
  if (blocks > 0x7fffffffu) return int(cudaErrorInvalidValue);
  flash_bwd_hb<DH><<<unsigned(blocks), hb_threads<DH>(), hb_smem_bytes<DH>(),
                     s>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dtype(const BwdArgs& a, int dh, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    switch (dh) {
      case 64: return launch_bwd_hb<64>(a, dh, s);
      case 96: return launch_bwd_hb<96>(a, dh, s);
      case 128: return launch_bwd_hb<128>(a, dh, s);
      case 256: return launch_bwd_hb<256>(a, dh, s);
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
// Three launches (float32) or two (bfloat16) on `stream`, no
// synchronisation, no allocation; returns a CUDA error code (0 =
// success).
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
