// Blocked online-softmax attention for Hopper (sm_90a): causal,
// sliding-window or bidirectional, grouped-query, float32 or bfloat16.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention.py:
// _flash_kernel (launcher `flash_attention`, its pallas_call).  That kernel
// walks (batch, head, q block, kv block) with the kv axis sequential and
// keeps the running max m, sum l and accumulator acc in VMEM scratch.  Here
// one thread block owns one (batch, head, query tile) and loops over the kv
// tiles itself; m, l and acc live in registers, so nothing carries between
// blocks.  Layout: q (B, Sq, H, Dh), k/v (B, Sk, KvH, Dh), o like q, all
// contiguous; query head h reads kv head h / (H / KvH).  Dh is one of the
// widths instantiated below; the wrapper zero-pads a narrower head to the
// next of them (the padded columns add exact zeros to every product) and
// passes the true width's scale.
//
// Semantics follow _flash_kernel line for line: s = (q . k) * scale in
// float32; keys >= Sk, above the diagonal (causal) or at or before
// q - window (window) are set to -1e30; m_new = max(m, rowmax s),
// alpha = exp(m - m_new), p = exp(s - m_new), l = l * alpha + rowsum p
// (p unrounded), acc = acc * alpha + round_to_v_dtype(p) @ v;
// o = acc / max(l, 1e-30) in q's dtype.  exp is expf (no exp2 folding, no
// fast math), so p equals the plain version's for the same s and m.
//
// What bounds it: at the slice's shape (B = 2, S = 4096, H = 32, Dh = 64,
// causal, bf16) the work is ~137 GFLOP of products against ~134 MB of
// traffic, so it is bound by operations: ~0.14 ms at the bf16 tensor-core
// peak.
//
// bfloat16 (flash_kernel_bf16): FlashAttention-2's layout on the tensor
// cores.  A block of 8 warps owns 128 query rows (16 per warp) and walks
// 64-key tiles; both products are mma.sync m16n8k16 bf16 x bf16 -> f32
// (exact products, f32 sums: only the order of the f32 sums differs from
// the reference).  The Q fragments are loaded once (ldmatrix) and stay in
// registers; K/V tiles are staged in shared memory as bf16 by cp.async,
// double-buffered so tile t + 1 loads while tile t computes; rows are
// padded by 16 bytes so ldmatrix is free of bank conflicts.  The scores
// stay in the accumulator registers: row max and row sum are quad
// shuffles, and the S accumulator becomes the A fragment of P.V by
// packing p to bf16 in registers (no shared-memory round trip).  Masks
// run only on tiles that cross the diagonal, the window's edge or Sk; a
// warp skips a tile wholly masked for its 16 rows (such a tile leaves m,
// l and acc unchanged once a row has seen a key, and rows only see keys
// from the first tile they visit on).  Blocks start with the heaviest
// causal query tiles.  What holds it back now: mma.sync reaches a part of
// the wgmma rate, a warp reads its K/V fragments from shared memory for
// 16 rows only, and the accurate expf costs ~10 instructions per score.
//
// float32 (flash_kernel_f32): the CUDA cores, with 64 x 64 tiles staged in
// shared memory as float32 and 4 x 4 register tiles (TF32 tensor cores
// would leave ~1e-3 relative error against the float32 tolerance of
// 2e-5).  256 threads: thread (ti, tj) = (tid / 16, tid % 16) owns query
// rows ti + 16 r (r < 4), score columns tj + 16 c (c < 4) and output
// columns GW g + CW tj .. + CW - 1 (g < Dh / GW): groups of GW = 64
// columns, CW = 4 a thread (float4), where 64 divides Dh, and of 32, CW =
// 2 (float2), where it does not (Dh 96); smem row strides are padded
// (Dh + 4, 64 + 16) so the vector reads are free of bank conflicts.
//
// The gradient: when asked (a non-null `lse`), both paths also write each
// query row's log-sum-exp of its scaled, masked scores, m + log l (l the
// sum of the unrounded p), which flash_attention_bwd.cu reads to recompute
// P = exp(s - lse).  Serving passes null: its launches write o alone,
// bit for bit as before the option existed.
//
// Head widths: Dh 64, 96, 128 and 256 in both dtypes.  A static_assert in
// each kernel refuses a width whose columns the thread mapping would not
// all cover, and one whose tiles would not fit the 227 KB of shared
// memory a block may opt into (f32 at Dh 256: 220 160 B; bf16 at Dh 256:
// 202 752 B).  bf16 at Dh 256 would need 128 accumulator + 64 Q-fragment
// + 32 score registers a thread, over the 255 a thread may have: above
// Dh 128 each k-step's Q fragment is re-read from the Q tile in shared
// memory on every kv tile (QREG false) instead of staying in registers.
//
// Wider heads (flash_wide_bf16, flash_wide_f32): the TPU kernel takes any
// Dh (its BlockSpec is (1, bq, 1, Dh)).  Here a Dh above 256 no longer
// fits one block's tiles or registers, so the wrapper pads it to a
// multiple of 64 and a grid axis splits the output columns into blocks of
// up to WIDE_OW = 256.  Each block forms S = Q K^T over the whole Dh by
// walking it in 64-column slices of Q and K staged in shared memory (bf16:
// a ring of two stages filled by cp.async), runs the online softmax as the
// kernels above do (same tiles, masks, expf, P rounded once to V's dtype),
// and multiplies P by its own columns of V.  Every column block computes
// the same S in the same order, so m, l and the lse agree in all of them;
// block 0 writes the lse.  What bounds it: the function is bound by
// operations as at the built widths (at B 2, S 4096, H 16, Dh 512, causal,
// ~550 GFLOP); the design repeats Q K^T once per column block (Dh / 256
// times) and re-reads the Q slices from L2 on every kv tile, the price of
// keeping S whole in registers at any Dh.  Shared memory: 89 088 B in
// bf16, 121 856 B in float32.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                      // (B, H, Sq) m + log l, or null
  int B, Sq, Sk, H, KvH;
  int causal, window;              // window < 0: none
  float scale;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;         // query rows per block
constexpr int F32_BK = 64;         // keys per kv tile
constexpr int F32_THREADS = 256;
constexpr int PS = F32_BK + 16;    // smem row stride of the P tile
constexpr int SMEM_OPTIN_BYTES = 232448;   // sm_90: 227 KB a block

template <int DH>
__host__ __device__ constexpr int f32_smem_floats() {
  return F32_BQ * (DH + 4) + 2 * F32_BK * (DH + 4) + F32_BQ * PS;
}

template <int DH>
__global__ void __launch_bounds__(F32_THREADS) flash_kernel_f32(FlashArgs a) {
  constexpr int BQ = F32_BQ, BK = F32_BK, THREADS = F32_THREADS;
  constexpr int DS = DH + 4;       // smem row stride of the Q/K/V tiles
  constexpr int GW = DH % 64 == 0 ? 64 : 32;   // output columns a group
  constexpr int CW = GW / 16;      // output columns a thread, per group
  constexpr int NG = DH / GW;      // groups
  static_assert(DH % 32 == 0 && DH > 0 && NG * GW == DH,
                "flash f32: every output column must belong to a group of "
                "16 threads x CW columns");
  static_assert(f32_smem_floats<DH>() * 4 <= SMEM_OPTIN_BYTES,
                "flash f32: tiles exceed the shared memory of a block");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * DS;
  float* vs = ks + BK * DS;
  float* ps = vs + BK * DS;

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KvH);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH, qi = q0 + r;
    qs[r * DS + d] = qi < a.Sq
        ? q[((size_t(b) * a.Sq + qi) * a.H + h) * DH + d] : 0.f;
  }

  float m[4], l[4], acc[4][CW * NG];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < CW * NG; ++e) acc[r][e] = 0.f;
  }

  int nk = (a.Sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // skip above diagonal
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // the previous tile's readers are done
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int r = idx / DH, d = idx % DH, kj = k0 + r;
      const size_t off = ((size_t(b) * a.Sk + kj) * a.KvH + kvh) * DH + d;
      ks[r * DS + d] = kj < a.Sk ? k[off] : 0.f;
      vs[r * DS + d] = kj < a.Sk ? v[off] : 0.f;
    }
    __syncthreads();

    // scores of this thread's 4 x 4 tile
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&qs[(ti + 16 * r) * DS + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&ks[(tj + 16 * c) * DS + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = s[r][c];
          t = fmaf(qv[r].x, kv[c].x, t);
          t = fmaf(qv[r].y, kv[c].y, t);
          t = fmaf(qv[r].z, kv[c].z, t);
          t = fmaf(qv[r].w, kv[c].w, t);
          s[r][c] = t;
        }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ti + 16 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tj + 16 * c;
        bool ok = kj < a.Sk;
        if (a.causal) ok = ok && kj <= qi;
        if (a.window >= 0) ok = ok && kj > qi - a.window;
        s[r][c] = ok ? s[r][c] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        ps[(ti + 16 * r) * PS + tj + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < CW * NG; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();

    // acc += P @ V
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pr[r] = *reinterpret_cast<const float4*>(&ps[(ti + 16 * r) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* vp = &vs[(j + jj) * DS + GW * g + CW * tj];
          float vv[CW];
          if constexpr (CW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vp);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vp);
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y
                          : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
            for (int e = 0; e < CW; ++e)
              acc[r][CW * g + e] = fmaf(p, vv[e], acc[r][CW * g + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ti + 16 * r;
    if (qi >= a.Sq) continue;
    if (a.lse && tj == 0)          // every thread of the row holds m and l
      a.lse[(size_t(b) * a.H + h) * a.Sq + qi] = m[r] + logf(l[r]);
    const float den = fmaxf(l[r], 1e-30f);
    float* row = o + (size_t(b) * a.Sq + qi) * a.H * DH + size_t(h) * DH;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < CW; ++e)
        row[GW * g + CW * tj + e] = acc[r][CW * g + e] / den;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int BF_WARPS = 8;
constexpr int BF_BQ = 16 * BF_WARPS;   // 128 query rows per block
constexpr int BF_BK = 64;              // keys per kv tile
constexpr int BF_THREADS = 32 * BF_WARPS;

template <int DH>
__host__ __device__ constexpr int bf_smem_bytes() {
  // Q tile, then two stages of (K tile, V tile); rows padded by 16 bytes
  return (BF_BQ + 4 * BF_BK) * (DH + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

// Stage rows [r0, r0 + rows) of a (B, S, heads, DH) bf16 tensor's head
// `hd` into smem rows of stride DH + 8; rows >= S are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int b,
                                           int S, int heads, int hd, int r0) {
  constexpr int CH = DH / 8;       // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += BF_THREADS) {
    const int r = idx / CH, c = idx % CH, t = r0 + r;
    const bool in = t < S;
    const __nv_bfloat16* g =
        src + ((size_t(b) * S + (in ? t : 0)) * heads + hd) * DH + 8 * c;
    cp_async16(dst + r * (DH + 8) + 8 * c, g, in ? 16 : 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(BF_THREADS) flash_kernel_bf16(FlashArgs a) {
  constexpr int DS = DH + 8;       // smem row stride, bf16 elements
  constexpr int KQ = DH / 16;      // k-steps of q.k
  constexpr int NS = BF_BK / 8;    // score n-tiles (8 keys each)
  constexpr int NO = DH / 8;       // output n-tiles (8 columns each)
  // Q fragments stay in registers up to Dh 128; above, re-read per k-step
  constexpr bool QREG = DH <= 128;
  static_assert(DH % 16 == 0 && DH > 0,
                "flash bf16: Dh must be whole 16-wide k-steps and pairs of "
                "8-column output tiles, or columns go unwritten");
  static_assert(bf_smem_bytes<DH>() <= SMEM_OPTIN_BYTES,
                "flash bf16: tiles exceed the shared memory of a block");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* kvs = qs + BF_BQ * DS;     // stage st: K at 2 st, V at 2 st + 1

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int nq = gridDim.y;
  const int q0 = (nq - 1 - blockIdx.y) * BF_BQ;   // heaviest tiles first
  const int kvh = h / (a.H / a.KvH);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);

  // kv tiles this block visits: above the diagonal and before the window
  // of its first row are wholly masked for every row
  int kt_end = (a.Sk + BF_BK - 1) / BF_BK;
  if (a.causal) kt_end = min(kt_end, (q0 + BF_BQ - 1) / BF_BK + 1);
  int kt_begin = 0;
  if (a.window >= 0) kt_begin = max(0, (q0 - a.window + 1) / BF_BK);
  kt_begin = min(kt_begin, kt_end);

  stage_rows<DH, BF_BQ>(qs, q, b, a.Sq, a.H, h, q0);
  if (kt_begin < kt_end) {
    stage_rows<DH, BF_BK>(kvs, k, b, a.Sk, a.KvH, kvh, kt_begin * BF_BK);
    stage_rows<DH, BF_BK>(kvs + BF_BK * DS, v, b, a.Sk, a.KvH, kvh,
                          kt_begin * BF_BK);
  }
  cp_async_commit();

  const int r_first = q0 + 16 * warp;       // this warp's query rows
  const int r_last = r_first + 15;
  const int row0 = r_first + g, row1 = row0 + 8;   // this thread's two rows

  uint32_t qf[QREG ? KQ : 1][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {         // prefetch the next tile into the other stage
      __nv_bfloat16* nx = kvs + 2 * (st ^ 1) * BF_BK * DS;
      stage_rows<DH, BF_BK>(nx, k, b, a.Sk, a.KvH, kvh, (kt + 1) * BF_BK);
      stage_rows<DH, BF_BK>(nx + BF_BK * DS, v, b, a.Sk, a.KvH, kvh,
                            (kt + 1) * BF_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (QREG && kt == kt_begin) {  // Q fragments, once
#pragma unroll
      for (int kk = 0; kk < (QREG ? KQ : 0); ++kk)
        ldmatrix_x4(qf[kk], qs + (16 * warp + (lane & 15)) * DS + 16 * kk
                                + 8 * (lane >> 4));
    }
    const __nv_bfloat16* ks = kvs + 2 * st * BF_BK * DS;
    const __nv_bfloat16* vs = ks + BF_BK * DS;
    const int k0 = kt * BF_BK;

    // a tile wholly masked for this warp's 16 rows changes nothing
    bool live = k0 < a.Sk;
    if (a.causal) live = live && k0 <= r_last;
    if (a.window >= 0) live = live && k0 + BF_BK - 1 > r_first - a.window;
    if (live) {
      // S = Q K^T (16 x 64 per warp), f32 accumulators
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        if (!QREG)                 // this k-step's Q fragment, again
          ldmatrix_x4(qf[0], qs + (16 * warp + (lane & 15)) * DS + 16 * kk
                                 + 8 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * DS
                              + 16 * kk + 8 * ((lane >> 3) & 1));
          mma_bf16(s[j], qf[QREG ? kk : 0], kb[0], kb[1]);
          mma_bf16(s[j + 1], qf[QREG ? kk : 0], kb[2], kb[3]);
        }
      }

      // scale, and mask only where this tile crosses an edge
      bool edge = k0 + BF_BK > a.Sk;
      if (a.causal) edge = edge || k0 + BF_BK - 1 > r_first;
      if (a.window >= 0) edge = edge || k0 <= r_last - a.window;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale;
          if (edge) {
            const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qi = e < 2 ? row0 : row1;
            bool ok = kj < a.Sk;
            if (a.causal) ok = ok && kj <= qi;
            if (a.window >= 0) ok = ok && kj > qi - a.window;
            if (!ok) x = NEG_INF;
          }
          s[j][e] = x;
        }

      // online softmax on the two rows, quad shuffles
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j][2 * r] = expf(s[j][2 * r] - m_new);
          s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);
          sum += s[j][2 * r] + s[j][2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + sum;       // per-thread part of the row sum
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // acc += bf16(P) V: the S accumulators are the A fragments of P
#pragma unroll
      for (int kk = 0; kk < BF_BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 7)
                                      + 8 * ((lane >> 3) & 1)) * DS
                                    + 8 * j + 8 * (lane >> 4));
          mma_bf16(acc[j], pa, vb[0], vb[1]);
          mma_bf16(acc[j + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();               // this stage is refilled two tiles on
  }
  cp_async_wait<0>();              // nothing in flight at exit

  // the row sums: quad shuffles of the per-thread parts
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? row1 : row0;
    if (qi >= a.Sq) continue;
    if (a.lse && t4 == 0)          // the quad holds the row's m and l
      a.lse[(size_t(b) * a.H + h) * a.Sq + qi] = m[r] + logf(l[r]);
    const float den = r ? den1 : den0;
    __nv_bfloat16* row = o + ((size_t(b) * a.Sq + qi) * a.H + h) * DH;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const uint32_t w = pack_bf16(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) = w;
    }
  }
}

// ---------------------------------------------------------------------------
// Dh above 256 (any multiple of 64: the wrapper pads to one): a grid axis
// over output column blocks, q.k walked in 64-column slices
// ---------------------------------------------------------------------------

constexpr int WIDE_SLICE = 64;     // columns of q.k one step stages
constexpr int WIDE_OW = 256;       // output columns a block owns, at most

// two stages of (Q slice, K slice), then the V tile's WIDE_OW columns;
// rows padded by 16 bytes
__host__ __device__ constexpr int wide_bf_smem_bytes() {
  return (2 * (BF_BQ + BF_BK) * (WIDE_SLICE + 8)
          + BF_BK * (WIDE_OW + 8)) * 2;
}
// the Q and K slices, the V tile, the P tile
__host__ __device__ constexpr int wide_f32_smem_floats() {
  return (F32_BQ + F32_BK) * (WIDE_SLICE + 4) + F32_BK * (WIDE_OW + 4)
       + F32_BQ * PS;
}
static_assert(wide_bf_smem_bytes() <= SMEM_OPTIN_BYTES &&
              wide_f32_smem_floats() * 4 <= SMEM_OPTIN_BYTES,
              "flash wide: tiles exceed the shared memory of a block");

// Stage rows [r0, r0 + ROWS), columns [d0, d0 + w) (w a multiple of 8) of
// head `hd` of a (B, S, heads, dh) bf16 tensor into smem rows of stride
// `ds`; rows >= S are zero-filled.
template <int ROWS>
__device__ __forceinline__ void stage_cols(__nv_bfloat16* dst, int ds,
                                           const __nv_bfloat16* src, int b,
                                           int S, int heads, int hd, int r0,
                                           int dh, int d0, int w) {
  const int ch = w / 8;            // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * ch; idx += BF_THREADS) {
    const int r = idx / ch, c = idx % ch, t = r0 + r;
    const bool in = t < S;
    const __nv_bfloat16* g =
        src + ((size_t(b) * S + (in ? t : 0)) * heads + hd) * dh + d0 + 8 * c;
    cp_async16(dst + r * ds + 8 * c, g, in ? 16 : 0);
  }
}

// bf16, grid (B H, query tiles, column blocks): flash_kernel_bf16's warps,
// masks and online softmax; S = Q K^T summed over dh / 64 slices of Q and
// K staged by cp.async in a ring of two (the next slice, or the next kv
// tile's first, loads while this one computes), then acc += bf16(P) V over
// the block's own output columns.  Every column block forms the same S in
// the same order, so m, l and the lse agree in all of them: block 0 writes
// the lse.
__global__ void __launch_bounds__(BF_THREADS) flash_wide_bf16(FlashArgs a,
                                                              int dh) {
  constexpr int SS = WIDE_SLICE + 8;       // slice row stride
  constexpr int VS = WIDE_OW + 8;          // V tile row stride
  constexpr int UNIT = (BF_BQ + BF_BK) * SS;   // one stage: Q then K slice
  constexpr int NS = BF_BK / 8;            // score n-tiles
  constexpr int NO = WIDE_OW / 8;          // output n-tiles of a full block
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* vs = ring + 2 * UNIT;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BF_BQ;   // heaviest first
  const int c0 = blockIdx.z * WIDE_OW;
  const int cw = min(WIDE_OW, dh - c0);    // this block's output columns
  const int nsl = dh / WIDE_SLICE;
  const int kvh = h / (a.H / a.KvH);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);

  int kt_end = (a.Sk + BF_BK - 1) / BF_BK;
  if (a.causal) kt_end = min(kt_end, (q0 + BF_BQ - 1) / BF_BK + 1);
  int kt_begin = 0;
  if (a.window >= 0) kt_begin = max(0, (q0 - a.window + 1) / BF_BK);
  kt_begin = min(kt_begin, kt_end);

  // slice sl of kv tile kt into stage st
  auto stage_slice = [&](int kt, int sl, int st) {
    __nv_bfloat16* dst = ring + st * UNIT;
    stage_cols<BF_BQ>(dst, SS, q, b, a.Sq, a.H, h, q0, dh, WIDE_SLICE * sl,
                      WIDE_SLICE);
    stage_cols<BF_BK>(dst + BF_BQ * SS, SS, k, b, a.Sk, a.KvH, kvh,
                      kt * BF_BK, dh, WIDE_SLICE * sl, WIDE_SLICE);
  };
  if (kt_begin < kt_end) stage_slice(kt_begin, 0, 0);
  cp_async_commit();

  const int r_first = q0 + 16 * warp, r_last = r_first + 15;
  const int row0 = r_first + g, row1 = row0 + 8;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BF_BK;
    bool live = k0 < a.Sk;
    if (a.causal) live = live && k0 <= r_last;
    if (a.window >= 0) live = live && k0 + BF_BK - 1 > r_first - a.window;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int sl = 0; sl < nsl; ++sl) {
      const int u = (kt - kt_begin) * nsl + sl;   // stage u & 1
      // the V tile joins the second slice's copies (its readers finished
      // with the tile before); dh > 256 makes 5 slices at least, so the
      // second slice's wait completes it
      if (sl == 0)
        stage_cols<BF_BK>(vs, VS, v, b, a.Sk, a.KvH, kvh, k0, dh, c0, cw);
      if (sl + 1 < nsl) stage_slice(kt, sl + 1, (u + 1) & 1);
      else if (kt + 1 < kt_end) stage_slice(kt + 1, 0, (u + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (live) {
        const __nv_bfloat16* qs = ring + (u & 1) * UNIT;
        const __nv_bfloat16* ks = qs + BF_BQ * SS;
#pragma unroll
        for (int kk = 0; kk < WIDE_SLICE / 16; ++kk) {
          uint32_t qf[4];
          ldmatrix_x4(qf, qs + (16 * warp + (lane & 15)) * SS + 16 * kk
                              + 8 * (lane >> 4));
#pragma unroll
          for (int j = 0; j < NS; j += 2) {
            uint32_t kb[4];
            ldmatrix_x4(kb, ks + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * SS
                                + 16 * kk + 8 * ((lane >> 3) & 1));
            mma_bf16(s[j], qf, kb[0], kb[1]);
            mma_bf16(s[j + 1], qf, kb[2], kb[3]);
          }
        }
      }
      __syncthreads();             // this stage is refilled next step
    }
    if (live) {
      bool edge = k0 + BF_BK > a.Sk;
      if (a.causal) edge = edge || k0 + BF_BK - 1 > r_first;
      if (a.window >= 0) edge = edge || k0 <= r_last - a.window;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale;
          if (edge) {
            const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qi = e < 2 ? row0 : row1;
            bool ok = kj < a.Sk;
            if (a.causal) ok = ok && kj <= qi;
            if (a.window >= 0) ok = ok && kj > qi - a.window;
            if (!ok) x = NEG_INF;
          }
          s[j][e] = x;
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j][2 * r] = expf(s[j][2 * r] - m_new);
          s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);
          sum += s[j][2 * r] + s[j][2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + sum;
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BF_BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          if (8 * j >= cw) break;  // past this block's columns
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 7)
                                      + 8 * ((lane >> 3) & 1)) * VS
                                    + 8 * j + 8 * (lane >> 4));
          mma_bf16(acc[j], pa, vb[0], vb[1]);
          mma_bf16(acc[j + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();               // the V tile is refilled next tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? row1 : row0;
    if (qi >= a.Sq) continue;
    if (a.lse && t4 == 0 && blockIdx.z == 0)
      a.lse[(size_t(b) * a.H + h) * a.Sq + qi] = m[r] + logf(l[r]);
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* row = o + ((size_t(b) * a.Sq + qi) * a.H + h) * dh + c0;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (8 * j >= cw) break;
      const uint32_t w = pack_bf16(acc[j][2 * r] / den,
                                   acc[j][2 * r + 1] / den);
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) = w;
    }
  }
}

// float32, grid (query tiles x column blocks, H, B): flash_kernel_f32's
// thread mapping; S summed over dh / 64 slices of Q and K staged in shared
// memory, then acc += P V over the block's own output columns (groups of
// 64, 4 a thread).  Block 0 of a query tile writes the lse.
__global__ void __launch_bounds__(F32_THREADS) flash_wide_f32(FlashArgs a,
                                                              int dh) {
  constexpr int BQ = F32_BQ, BK = F32_BK, THREADS = F32_THREADS;
  constexpr int SS = WIDE_SLICE + 4;       // slice row stride
  constexpr int VS = WIDE_OW + 4;          // V tile row stride
  constexpr int NG = WIDE_OW / 64;         // output column groups, at most
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * SS;
  float* vs = ks + BK * SS;
  float* ps = vs + BK * VS;

  const int ncb = (dh + WIDE_OW - 1) / WIDE_OW;
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int q0 = blockIdx.x / ncb * BQ, cb = blockIdx.x % ncb;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = cb * WIDE_OW, cw = min(WIDE_OW, dh - c0);
  const int nsl = dh / WIDE_SLICE;
  const int kvh = h / (a.H / a.KvH);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NG; ++e) acc[r][e] = 0.f;
  }

  int nk = (a.Sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int sl = 0; sl < nsl; ++sl) {
      const int d0 = WIDE_SLICE * sl;
      __syncthreads();             // the previous step's readers are done
      for (int idx = tid; idx < BQ * WIDE_SLICE; idx += THREADS) {
        const int r = idx / WIDE_SLICE, d = idx % WIDE_SLICE, qi = q0 + r;
        qs[r * SS + d] = qi < a.Sq
            ? q[((size_t(b) * a.Sq + qi) * a.H + h) * dh + d0 + d] : 0.f;
      }
      for (int idx = tid; idx < BK * WIDE_SLICE; idx += THREADS) {
        const int r = idx / WIDE_SLICE, d = idx % WIDE_SLICE, kj = k0 + r;
        ks[r * SS + d] = kj < a.Sk
            ? k[((size_t(b) * a.Sk + kj) * a.KvH + kvh) * dh + d0 + d] : 0.f;
      }
      if (sl == 0)
        for (int idx = tid; idx < BK * cw; idx += THREADS) {
          const int r = idx / cw, d = idx % cw, kj = k0 + r;
          vs[r * VS + d] = kj < a.Sk
              ? v[((size_t(b) * a.Sk + kj) * a.KvH + kvh) * dh + c0 + d]
              : 0.f;
        }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < WIDE_SLICE; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          qv[r] = *reinterpret_cast<const float4*>(
              &qs[(ti + 16 * r) * SS + d]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          kv[c] = *reinterpret_cast<const float4*>(
              &ks[(tj + 16 * c) * SS + d]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float t = s[r][c];
            t = fmaf(qv[r].x, kv[c].x, t);
            t = fmaf(qv[r].y, kv[c].y, t);
            t = fmaf(qv[r].z, kv[c].z, t);
            t = fmaf(qv[r].w, kv[c].w, t);
            s[r][c] = t;
          }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ti + 16 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tj + 16 * c;
        bool ok = kj < a.Sk;
        if (a.causal) ok = ok && kj <= qi;
        if (a.window >= 0) ok = ok && kj > qi - a.window;
        s[r][c] = ok ? s[r][c] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        ps[(ti + 16 * r) * PS + tj + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * NG; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pr[r] = *reinterpret_cast<const float4*>(&ps[(ti + 16 * r) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          if (64 * gi >= cw) break;
          const float4 t = *reinterpret_cast<const float4*>(
              &vs[(j + jj) * VS + 64 * gi + 4 * tj]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y
                          : jj == 2 ? pr[r].z : pr[r].w;
            acc[r][4 * gi] = fmaf(p, t.x, acc[r][4 * gi]);
            acc[r][4 * gi + 1] = fmaf(p, t.y, acc[r][4 * gi + 1]);
            acc[r][4 * gi + 2] = fmaf(p, t.z, acc[r][4 * gi + 2]);
            acc[r][4 * gi + 3] = fmaf(p, t.w, acc[r][4 * gi + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ti + 16 * r;
    if (qi >= a.Sq) continue;
    if (a.lse && tj == 0 && cb == 0)
      a.lse[(size_t(b) * a.H + h) * a.Sq + qi] = m[r] + logf(l[r]);
    const float den = fmaxf(l[r], 1e-30f);
    float* row = o + ((size_t(b) * a.Sq + qi) * a.H + h) * dh + c0;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      if (64 * gi >= cw) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[64 * gi + 4 * tj + e] = acc[r][4 * gi + e] / den;
    }
  }
}

int launch_wide(const FlashArgs& a, int dh, int dtype, cudaStream_t s) {
  const int ncb = (dh + WIDE_OW - 1) / WIDE_OW;
  if (dtype == 1) {
    const int nq = (a.Sq + BF_BQ - 1) / BF_BQ;
    if (nq > 65535 || ncb > 65535 || size_t(a.B) * a.H > 0x7fffffffu)
      return int(cudaErrorInvalidValue);
    const int bytes = wide_bf_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        flash_wide_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
    flash_wide_bf16<<<dim3(a.B * a.H, nq, ncb), BF_THREADS, bytes, s>>>(a,
                                                                        dh);
    return int(cudaGetLastError());
  }
  const size_t nx = size_t((a.Sq + F32_BQ - 1) / F32_BQ) * ncb;
  if (nx > 0x7fffffffu) return int(cudaErrorInvalidValue);
  const int bytes = wide_f32_smem_floats() * int(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  flash_wide_f32<<<dim3(unsigned(nx), a.H, a.B), F32_THREADS, bytes, s>>>(
      a, dh);
  return int(cudaGetLastError());
}

template <int DH>
int launch_f32(const FlashArgs& a, cudaStream_t s) {
  const int bytes = f32_smem_floats<DH>() * int(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Sq + F32_BQ - 1) / F32_BQ, a.H, a.B);
  flash_kernel_f32<DH><<<grid, F32_THREADS, bytes, s>>>(a);
  return int(cudaGetLastError());
}

template <int DH>
int launch_bf16(const FlashArgs& a, cudaStream_t s) {
  const int bytes = bf_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(a.B * a.H, (a.Sq + BF_BQ - 1) / BF_BQ);
  flash_kernel_bf16<DH><<<grid, BF_THREADS, bytes, s>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16.  `lse` is null, or (B, H, Sq) float32 that receives each
// query row's log-sum-exp of its scaled, masked scores (m + log l), which
// the backward kernel (flash_attention_bwd.cu) reads; the serving
// launches pass null and write nothing more.  Launches on `stream`, does
// not synchronise, allocates nothing; returns a CUDA error code (0 =
// success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int KvH, int Dh, int causal, int window,
    float scale, int dtype, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 1 || H < 1 || KvH < 1 || H % KvH != 0 ||
      B > 65535 || H > 65535 || (dtype == 1 && Sq > 65535 * BF_BQ))
    return int(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  const FlashArgs a{q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H,
                    KvH, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (Dh) {
      case 64: return launch_f32<64>(a, s);
      case 96: return launch_f32<96>(a, s);
      case 128: return launch_f32<128>(a, s);
      case 256: return launch_f32<256>(a, s);
    }
  } else if (dtype == 1) {
    switch (Dh) {
      case 64: return launch_bf16<64>(a, s);
      case 96: return launch_bf16<96>(a, s);
      case 128: return launch_bf16<128>(a, s);
      case 256: return launch_bf16<256>(a, s);
    }
  }
  if ((dtype == 0 || dtype == 1) && Dh > 256 && Dh % WIDE_SLICE == 0)
    return launch_wide(a, Dh, dtype, s);
  return int(cudaErrorInvalidValue);
}

#endif
