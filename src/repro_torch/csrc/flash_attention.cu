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
// fast math), so p equals the plain version's for the same s and m, in
// the bf16 kernel at the built widths; the kernels on wgmma (bf16 past Dh
// 256, float32 at every width) fold the scale into log2 units and take
// ex2.approx (see flash_fwd_hw's section).
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
// float32 runs flash_fwd_hf at every width (the wide section below: every
// operand split into three bf16 parts on wgmma; TF32 tensor cores would
// leave ~1e-3 relative error against the float32 tolerance of 2e-5), the
// wrapper padding Dh 96 to 128: at Dh 64 and 128 each 128-row block holds
// the whole head, so it runs alone (no exchange, no cluster barrier); at
// Dh 256 two column blocks in a cluster.  The CUDA-core kernel it replaced
// (64 x 64 tiles) took 1.33x SDPA's float32 time at phi-3's shape and paid
// every kv tile from 0 under a window (H100, PERF.md).
//
// The gradient: when asked (a non-null `lse`), both paths also write each
// query row's log-sum-exp of its scaled, masked scores, m + log l (l the
// sum of the unrounded p), which flash_attention_bwd.cu reads to recompute
// P = exp(s - lse).  Serving passes null: its launches write o alone,
// bit for bit as before the option existed.
//
// Head widths: bf16 Dh 64, 96, 128 and 256 here (flash_kernel_bf16),
// float32 any multiple of 64.  A static_assert in the bf16 kernel refuses
// a width whose columns the thread mapping would not all cover, and one
// whose tiles would not fit the 227 KB of shared memory a block may opt
// into (at Dh 256: 202 752 B).  bf16 at Dh 256 would need 128 accumulator
// + 64 Q-fragment + 32 score registers a thread, over the 255 a thread may
// have: above Dh 128 each k-step's Q fragment is re-read from the Q tile
// in shared memory on every kv tile (QREG false) instead of staying in
// registers.
//
// Wider heads (flash_fwd_hw, flash_fwd_hf): the TPU kernel takes any Dh
// (its BlockSpec is (1, bq, 1, Dh)).  Here a Dh above 256 no longer fits
// one block's tiles or registers, so the wrapper pads it to a multiple of
// 64 and each block owns a column block of the head: a thread-block
// cluster of the column blocks on wgmma, each forming a partial S over its
// own columns, the partials summed in rank order through distributed
// shared memory (the design and why in flash_fwd_hw's section), so m, l
// and the lse agree in every block and block 0 writes the lse.  float32
// (flash_fwd_hf) splits every float32 operand into three bf16 parts (v =
// hi + mid + lo, every bit of v) and runs a product as six bf16 part
// products (all whose bits reach 2^-24 of it; TF32 keeps 10 bits and would
// miss the float32 tolerance), in column blocks of one or two chunks,
// each owner of a run of the exchange's items writing the totals into
// every block; P stays float32.  What bounds them: the function is bound
// by operations as at the built widths (at B 2, S 4096, H 16, Dh 512,
// causal, ~550 GFLOP; in float32 the tensor cores give 989 / 6 TFLOP/s of
// float32-exact products).  Shared memory: 230 400 B in bf16, 230 400 B
// in float32.

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

constexpr int SMEM_OPTIN_BYTES = 232448;   // sm_90: 227 KB a block

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
// Dh above 256 (any multiple of 64: the wrapper pads to one)
// ---------------------------------------------------------------------------

// bfloat16 (flash_fwd_hw): a thread-block cluster of column blocks on the
// tensor cores, the forward of flash_attention_bwd.cu's flash_bwd_hw
// (design a).  Taken over column blocks that each form S over the whole
// head (design b) because it stages every tile once a block (Q once, K and
// V once a kv tile) and forms Q K^T once a cluster: two products where
// the function needs two, against Dh / 256 + 1 for design b, whose blocks
// also re-read Q from L2 every kv tile.  What it pays instead is the
// exchange: two cluster barrier phases a kv tile and 32 KB of partials a
// block through distributed shared memory.  In turns at B 2, S 4096, H
// 16, Dh 512, causal (H100, PERF.md) design b, as built below for more
// than 8 column blocks, took 2.91 ms against 2.20 for design a (6.3 for
// the mma.sync kernel it replaces, 4.7 for SDPA).  What holds it back
// there: of 2.2 ms the cluster barriers ~0.30, the distributed shared
// memory 0.24, the partial products 0.24, the copies 0.16; one block an
// SM, its two warpgroups in step, so little hides a step's latencies.
//
// A block owns 128 query rows (two warpgroups of 64) and one column block:
// the head's 64-column chunks are dealt into ncb = ceil(Dh / 256) blocks of
// 2-4 chunks, and block c stages only its own columns of Q (once), K and V
// (each kv tile, two stages each), in bf16 by cp.async into the 128-byte
// swizzle.  Per kv tile each warpgroup forms its partial S_c = Q_c K_c^T
// (a wgmma m64n64k16 chain, both operands K-major) and publishes it, and
// after a cluster barrier sums the ncb partials in rank order, so every
// block holds the same S, m, l and P bit for bit: at two ranks each block
// writes its partial into the peer's exchange and keeps its own in
// registers (a + b is b + a), past two each reads the others' from their
// exchanges.  Then acc_c += bf16(P) V_c: register-A wgmma, P packed from
// the scores as they lie, V_c read MN-major.  The exchange is one buffer:
// a second barrier phase a tile says it has been read, and each phase has
// work between its arrive and its wait (the softmax, the PV product).
// Shared memory: Q_c 64 KB, two K_c and two V_c 128 KB, the exchange 32
// KB: 225 KB of the 227 a block may have, one block an SM.  No atomics: a
// call repeats bit for bit, and block 0's lse is every block's.
//
// The softmax keeps flash_kernel_bf16's masks and tile skipping, per
// warpgroup (a tile wholly masked for its 64 rows is skipped; every block
// of a cluster skips alike), with the scale folded into log2 units: p =
// 2^(s scale log2e - m) by ex2.approx (relative error ~2^-22 before P's
// rounding to bf16), m + log l = m ln 2 + log l.  A cluster holds at most
// 8 blocks (the portable limit: Dh <= 2048); past that the same kernel runs
// without a cluster, each block forming S over the whole head itself, one
// column block's Q and K chunks after another (design b, unpipelined).
constexpr int FW_ROWS = 128;       // query rows of a block: two warpgroups
constexpr int FW_BK = 64;          // keys of a kv tile
constexpr int FW_CHUNK = 64;       // columns of a chunk: a 128-byte line
constexpr int FW_MAX_CHUNKS = 4;   // chunks of a column block, at most
constexpr int FW_CLUSTER = 8;      // blocks of a cluster, at most (portable)
constexpr int FW_QB = FW_MAX_CHUNKS * FW_ROWS * 128;   // the Q tile, 64 KB
constexpr int FW_KB = FW_MAX_CHUNKS * FW_BK * 128;     // a K or V tile, 32 KB
constexpr int FW_XB = FW_ROWS * FW_BK * 4;             // an exchange, 32 KB
// Q, two stages of K and of V, the exchange, 1024 bytes to align
constexpr int FW_SMEM_BYTES = FW_QB + 4 * FW_KB + FW_XB + 1024;
static_assert(FW_SMEM_BYTES <= SMEM_OPTIN_BYTES,
              "flash fwd hw: tiles exceed the shared memory of a block");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// flash_attention_bwd.cu's wgmma, swizzle and cluster helpers, repeated:
// each source builds alone
// copies made by the threads (cp.async) visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// wgmma's shared-memory matrix descriptor of a K-major tile in the
// 128-byte swizzle: start address, leading offset 16 bytes (unused in
// this swizzle), 1024 bytes between 8-row groups, swizzle mode 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16)
       | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// wgmma's descriptor of an MN-major tile of 64 rows in the 128-byte
// swizzle (the B operand of a product that contracts over the tile's
// rows): 8192 bytes between 64-column chunks, 1024 between 8-row groups
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(8192 >> 4) << 16)
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
// keeps the compiler from moving a use of d across the wgmma's issue or
// wait
template <int N = 32>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the arrive after a step's partials are read: no release fence, since the
// loads are consumed before it (0.29 ms of 2.5 at Dh 512, H100, in turns:
// PERF.md); the block's copies become visible by a block barrier after
// its wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
// the generic address of `p`'s counterpart in the shared memory of the
// cluster's block `rank` (plain loads from it are ordered by the barriers)
__device__ __forceinline__ const float4* peer(const float4* p, int rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float4*>(out);
}
// 2^x by the SFU's approximation (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float fw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte piece c of row r in a swizzled tile of ROWS rows
// (piece c of chunk c / 8: chunks ROWS x 128 bytes apart)
template <int ROWS>
__device__ __forceinline__ uint32_t fw_swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// rows [r0, r0 + ROWS), chunks [ch0, ch0 + nc) of head `hd` of a (B, S,
// heads, dh) bf16 tensor into a swizzled tile by cp.async; rows >= S
// zeros.  Lane l of warp w copies 16-byte piece l of rows w + 8 i (a row
// of up to 4 chunks is 32 pieces; lanes past nc chunks idle): its piece
// lands at one swizzled slot of every 8-row group, 1024 bytes apart, and
// one running pointer walks the rows (the copies run while the scores and
// the accumulator hold most of the registers)
template <int ROWS>
__device__ __forceinline__ void fw_stage(unsigned char* dst, const void* src,
                                         int b, int S, int heads, int hd,
                                         int r0, int dh, int ch0, int nc) {
  const int c = threadIdx.x % 32, w = threadIdx.x / 32;
  if (c >= nc * (FW_CHUNK / 8)) return;
  const size_t stride = size_t(heads) * dh * 8;    // 8 rows apart
  const __nv_bfloat16* row0 = static_cast<const __nv_bfloat16*>(src)
      + (size_t(b) * S * heads + hd) * dh + FW_CHUNK * ch0 + 8 * c;
  const __nv_bfloat16* g = row0 + size_t(r0 + w) * heads * dh;
  unsigned char* d = dst + fw_swz<ROWS>(w, c);
#pragma unroll 4
  for (int i = 0; i < ROWS / 8; ++i, g += stride, d += 1024) {
    const bool in = r0 + w + 8 * i < S;
    cp_async16(d, in ? g : row0, in ? 16 : 0);
  }
}

// d (the warpgroup's 64 x 64 f32 scores, accumulator order) = [d +] a .
// b^T over NC chunks: a the warpgroup's 64 rows of the Q tile, b the K
// tile, both K-major; one wgmma chain, waited for
template <int NC>
__device__ __forceinline__ void fw_scores(float d[32], const unsigned char* a,
                                          const unsigned char* b,
                                          bool accumulate) {
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) {
    const int off = (kk & 3) * 32;
    wgmma_64x64(d, sw128_desc(a + (kk >> 2) * (FW_ROWS * 128) + off),
                sw128_desc(b + (kk >> 2) * (FW_BK * 128) + off),
                accumulate || kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
}

// acc (the warpgroup's 64 x 64 NC f32) += p (64 x 64 bf16: four k-steps of
// register fragments) . v (the V tile's 64 keys x NC chunks, read
// MN-major): one register-A wgmma chain, waited for
template <int NC>
__device__ __forceinline__ void fw_pv(float* acc, const uint32_t p[4][4],
                                      const unsigned char* v) {
  fence_acc<NC * 32>(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned char* rows = v + kk * 16 * 128;
#pragma unroll
    for (int c = 0; c + 1 < NC; c += 2)
      wgmma_rs<128>(acc + 32 * c, p[kk], mn_desc(rows + c * (FW_BK * 128)));
    if constexpr (NC % 2 == 1)
      wgmma_rs<64>(acc + 32 * (NC - 1), p[kk],
                   mn_desc(rows + (NC - 1) * (FW_BK * 128)));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc<NC * 32>(acc);
}

// the scores s: the cluster's `ranks` partials summed in rank order, from
// this thread's slot `mine` of the exchange (8 float4 128 apart) in each
// block's shared memory (its own read locally), half a slot at a time
__device__ __forceinline__ void fw_totals(float s[32], const float4* mine,
                                          int ranks, int me) {
  for (int r = 0; r < ranks; ++r) {
    const float4* src = r == me ? mine : peer(mine, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = src[(4 * h + j) * 128];
        t[4 * j] = v.x; t[4 * j + 1] = v.y; t[4 * j + 2] = v.z;
        t[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        s[16 * h + i] = r == 0 ? t[i] : s[16 * h + i] + t[i];
    }
  }
}

struct FwArgs {
  int dh, nch, ncb;                // padded Dh, its chunks, column blocks
  int ranks;                       // blocks summing partials (ncb), or 1:
                                   // each block forms S over the head
};

// a block's place: (batch, head), its query tile (heaviest first), the kv
// tiles its rows see, its threads' rows
struct FwPlace {
  int b, h, kvh, q0, kt_begin, kt_end;
  int wg, r_first, r_last, row0, row1, t4;
  __device__ FwPlace(const FlashArgs& a, const FwArgs& x) {
    const int bh = blockIdx.x / x.ncb;
    b = bh / a.H;
    h = bh % a.H;
    kvh = h / (a.H / a.KvH);
    q0 = (gridDim.y - 1 - blockIdx.y) * FW_ROWS;
    kt_end = (a.Sk + FW_BK - 1) / FW_BK;
    if (a.causal) kt_end = min(kt_end, (q0 + FW_ROWS - 1) / FW_BK + 1);
    kt_begin = 0;
    if (a.window >= 0) kt_begin = max(0, (q0 - a.window + 1) / FW_BK);
    kt_begin = min(kt_begin, kt_end);
    wg = threadIdx.x / 128;
    r_first = q0 + 64 * wg;                  // the warpgroup's 64 rows
    r_last = r_first + 63;
    const int lane = threadIdx.x % 32;
    row0 = r_first + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    row1 = row0 + 8;                         // the thread's two rows
    t4 = lane % 4;
  }
  // a kv tile wholly masked for the warpgroup's rows changes nothing
  __device__ bool live(const FlashArgs& a, int kt) const {
    const int k0 = kt * FW_BK;
    bool ok = true;
    if (a.causal) ok = k0 <= r_last;
    if (a.window >= 0) ok = ok && k0 + FW_BK - 1 > r_first - a.window;
    return ok;
  }
};

// kv tile kt's scores s (the warpgroup's, accumulator order) into P: scale
// into log2 units, mask where the tile crosses an edge, the online
// softmax on the thread's two rows (m in log2 units, l its part of the row
// sum, acc rescaled); P left in s, float32
template <int NC>
__device__ __forceinline__ void fw_softmax(float s[32], float m[2],
                                           float l[2], float* acc,
                                           const FlashArgs& a,
                                           const FwPlace& p, float sl2,
                                           int kt) {
  const int k0 = kt * FW_BK;
  bool edge = k0 + FW_BK > a.Sk;
  if (a.causal) edge = edge || k0 + FW_BK - 1 > p.r_first;
  if (a.window >= 0) edge = edge || k0 <= p.r_last - a.window;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * j + e] * sl2;
      if (edge) {
        const int kj = k0 + 8 * j + 2 * p.t4 + (e & 1);
        const int qi = e < 2 ? p.row0 : p.row1;
        bool ok = kj < a.Sk;
        if (a.causal) ok = ok && kj <= qi;
        if (a.window >= 0) ok = ok && kj > qi - a.window;
        if (!ok) v = NEG_INF;
      }
      s[4 * j + e] = v;
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = fw_exp2(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j + 2 * r] = fw_exp2(s[4 * j + 2 * r] - m_new);
      s[4 * j + 2 * r + 1] = fw_exp2(s[4 * j + 2 * r + 1] - m_new);
      sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + sum;
  }
#pragma unroll
  for (int j = 0; j < NC * 8; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}
// P rounded to bf16 as k-step fragments (score n-tiles 2 kk and 2 kk + 1
// make k-step kk)
__device__ __forceinline__ void fw_pack(uint32_t pa[4][4], const float s[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// o = acc / max(l, 1e-30) over the block's columns, and (column block 0)
// the row lse = m ln 2 + log l
template <int NC>
__device__ __forceinline__ void fw_store(const FlashArgs& a, const FwArgs& x,
                                         const FwPlace& p, float* acc,
                                         float m[2], float l[2], int cb) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int ch0 = cb * x.nch / x.ncb;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? p.row1 : p.row0;
    if (qi >= a.Sq) continue;
    if (a.lse && p.t4 == 0 && cb == 0)     // the quad holds the row's m, l
      a.lse[(size_t(p.b) * a.H + p.h) * a.Sq + qi] =
          (m[r] == NEG_INF ? NEG_INF : m[r] * LN2) + logf(l[r]);
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* row = static_cast<__nv_bfloat16*>(a.o)
        + ((size_t(p.b) * a.Sq + qi) * a.H + p.h) * x.dh + FW_CHUNK * ch0;
#pragma unroll
    for (int j = 0; j < NC * 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * p.t4) =
          pack_bf16(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
  }
}

// column block cb (NC chunks) of one (128-row query tile, head, batch) in
// a cluster of ranks blocks.  Kv tile i's step, software-pipelined so that
// each cluster barrier has work between its arrive and its wait:
//   wait B_i (tile i's partials are in place) -> stage K_{i+2} -> the
//   scores: at two ranks this block's partial (kept in registers) plus the
//   peer's, which the peer wrote into this block's exchange; past two,
//   every rank's partial from its own exchange, in rank order -> arrive
//   R_i (read; this thread's K_{i+1} and V_i have landed) -> softmax ->
//   wait R_i, block barrier -> stage V_{i+1} -> S_{i+1}'s partial
//   published -> arrive B_{i+1} -> acc += bf16(P_i) V_i.
// K and V in two stages each, the exchange in one buffer (R_i frees it).
template <int NC>
__device__ __forceinline__ void fw_cluster(const FlashArgs& a,
                                           const FwArgs& x,
                                           unsigned char* sm, int cb) {
  const FwPlace p(a, x);
  const int ch0 = cb * x.nch / x.ncb, n = p.kt_end - p.kt_begin;
  const bool push = x.ranks == 2;
  const unsigned char* qw = sm + p.wg * 64 * 128;   // the warpgroup's Q rows
  unsigned char* ks = sm + FW_QB;                  // two stages
  unsigned char* vs = ks + 2 * FW_KB;              // two stages
  // this thread's slot of the exchange ([wg][n-tile j][thread] float4) and
  // where its partials go: the peer's slot at two ranks, else its own
  float4* mine = reinterpret_cast<float4*>(vs + 2 * FW_KB)
      + p.wg * 1024 + threadIdx.x % 128;
  float4* out = push ? const_cast<float4*>(peer(mine, 1 - cb)) : mine;
  auto stage_kv = [&](unsigned char* dst, const void* src, int i) {
    fw_stage<FW_BK>(dst, src, p.b, a.Sk, a.KvH, p.kvh,
                    (p.kt_begin + i) * FW_BK, x.dh, ch0, NC);
  };
  // S_i's partial Q_c K_c^T into s and out
  auto publish = [&](float s[32], int i) {
    if (!p.live(a, p.kt_begin + i)) return;
    fw_scores<NC>(s, qw, ks + (i & 1) * FW_KB, false);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j * 128] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                 s[4 * j + 3]);
  };
  const float sl2 = a.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NC * 32];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) acc[i] = 0.f;
  float s[32];                             // a partial, then the scores

  if (n > 0) {
    fw_stage<FW_ROWS>(sm, a.q, p.b, a.Sq, a.H, p.h, p.q0, x.dh, ch0, NC);
    stage_kv(ks, a.k, 0);
    stage_kv(vs, a.v, 0);
    cp_async_commit();
    if (n > 1) stage_kv(ks + FW_KB, a.k, 1);
    cp_async_commit();
    cp_async_wait<1>();                    // Q, K_0 and V_0 have landed
    fence_proxy_async();
    __syncthreads();
    cluster_arrive();                      // every block of the cluster
    cluster_wait();                        // runs: its memory may be written
    publish(s, 0);
    cluster_arrive();                      // B_0
  }
  for (int i = 0; i < n; ++i) {
    const bool live = p.live(a, p.kt_begin + i);
    cluster_wait();                        // B_i: tile i's partials are in
    if (i + 2 < n) stage_kv(ks + (i & 1) * FW_KB, a.k, i + 2);
    cp_async_commit();
    if (live && push) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = mine[j * 128];
        s[4 * j] += v.x; s[4 * j + 1] += v.y; s[4 * j + 2] += v.z;
        s[4 * j + 3] += v.w;
      }
    } else if (live) {
      fw_totals(s, mine, x.ranks, cb);
    }
    cp_async_wait<1>();                    // K_{i+1} and V_i have landed
    fence_proxy_async();
    cluster_arrive_relaxed();              // R_i
    uint32_t pa[4][4];
    if (live) {
      fw_softmax<NC>(s, m, l, acc, a, p, sl2, p.kt_begin + i);
      fw_pack(pa, s);
    }
    cluster_wait();                        // R_i: every block has read tile
    __syncthreads();                       // i's partials; every thread's
                                           // copies are visible
    if (i + 1 < n) stage_kv(vs + ((i + 1) & 1) * FW_KB, a.v, i + 1);
    cp_async_commit();
    if (i + 1 < n) {
      publish(s, i + 1);
      cluster_arrive();                    // B_{i+1}
    }
    if (live) fw_pv<NC>(acc, pa, vs + (i & 1) * FW_KB);
  }
  cp_async_wait<0>();                      // nothing in flight at exit
  fw_store<NC>(a, x, p, acc, m, l, cb);
}

// column block cb (NC chunks) without a cluster (more column blocks than a
// cluster holds): per kv tile, S over the whole head, one column block's
// Q and K chunks after another staged and multiplied in turn, then acc_c
// += bf16(P) V_c with V in two stages
template <int NC>
__device__ __forceinline__ void fw_solo(const FlashArgs& a, const FwArgs& x,
                                        unsigned char* sm, int cb) {
  const FwPlace p(a, x);
  const int ch0 = cb * x.nch / x.ncb;
  const unsigned char* qw = sm + p.wg * 64 * 128;
  unsigned char* ks = sm + FW_QB;
  unsigned char* vs = ks + 2 * FW_KB;              // two stages
  auto stage_v = [&](int st, int kt) {
    fw_stage<FW_BK>(vs + st * FW_KB, a.v, p.b, a.Sk, a.KvH, p.kvh,
                    kt * FW_BK, x.dh, ch0, NC);
  };
  if (p.kt_begin < p.kt_end) stage_v(0, p.kt_begin);
  cp_async_commit();
  const float sl2 = a.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NC * 32];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) acc[i] = 0.f;

  for (int kt = p.kt_begin; kt < p.kt_end; ++kt) {
    const int st = (kt - p.kt_begin) & 1;
    const bool live = p.live(a, kt);
    float s[32];
    for (int c = 0; c < x.ncb; ++c) {      // one column block at a time
      const int c0 = c * x.nch / x.ncb, cn = (c + 1) * x.nch / x.ncb - c0;
      __syncthreads();                     // the last chunks' readers done
      if (c == 0 && kt + 1 < p.kt_end) stage_v(st ^ 1, kt + 1);
      fw_stage<FW_ROWS>(sm, a.q, p.b, a.Sq, a.H, p.h, p.q0, x.dh, c0, cn);
      fw_stage<FW_BK>(ks, a.k, p.b, a.Sk, a.KvH, p.kvh, kt * FW_BK, x.dh,
                      c0, cn);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      if (!live) continue;
      if (cn == 2) fw_scores<2>(s, qw, ks, c > 0);
      else if (cn == 3) fw_scores<3>(s, qw, ks, c > 0);
      else fw_scores<4>(s, qw, ks, c > 0);
    }
    if (!live) continue;
    uint32_t pa[4][4];
    fw_softmax<NC>(s, m, l, acc, a, p, sl2, kt);
    fw_pack(pa, s);
    fw_pv<NC>(acc, pa, vs + st * FW_KB);
  }
  cp_async_wait<0>();
  fw_store<NC>(a, x, p, acc, m, l, cb);
}

template <int NC>
__device__ __forceinline__ void fw_block(const FlashArgs& a, const FwArgs& x,
                                         unsigned char* sm, int cb) {
  if (x.ranks > 1) fw_cluster<NC>(a, x, sm, cb);
  else fw_solo<NC>(a, x, sm, cb);
}

// grid (ncb B H, query tiles): block x is column block x % ncb of (batch,
// head) x / ncb, a cluster of the ncb column blocks (ranks = ncb) or, past
// FW_CLUSTER of them, no cluster (ranks = 1)
__global__ void __launch_bounds__(256, 1) flash_fwd_hw(FlashArgs a,
                                                       FwArgs x) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  const int cb = blockIdx.x % x.ncb;
  const int nc = (cb + 1) * x.nch / x.ncb - cb * x.nch / x.ncb;
  if (nc == 2) fw_block<2>(a, x, sm, cb);
  else if (nc == 3) fw_block<3>(a, x, sm, cb);
  else fw_block<4>(a, x, sm, cb);
}

// float32 (flash_fwd_hf, every width): flash_fwd_hw's cluster on the
// tensor cores with every operand split into three bf16 parts (the
// header's design), one or two 64-column chunks a column block (ncb =
// ceil(Dh / 128): 4 a cluster at Dh 512, Dh <= 1024 in a cluster; at Dh 64
// and 128 one block holds the head and runs alone, FF_ONE, with Q split
// once and resident, K and V copied a step ahead and split while a chain
// runs, and no exchange; at Dh 256 a cluster of 2).  The parts triple the
// bf16 tiles'
// bytes, so K and V have one stage and the K tile doubles as the
// exchange, which is free between a tile's partial product and the next
// tile's K; one buffer of float32 slots takes each thread's cp.async
// copies a step ahead (cp.async cannot split), split in while a chain
// runs.  The owners of the exchange's items sum the cluster's partials
// and write the totals into every block (two cluster barrier phases a kv
// tile); P stays float32, split for its product; each chain's sums begin
// at zero and are added in float32.  Against one-chunk blocks (8 ranks at
// Dh 512) the two-chunk ones halve the exchange, the barriers and the
// softmax a product pays (PERF.md)
constexpr int FF_PARTS = 3;        // bf16 parts of a float32 operand
// part products of a . b, pair p = (a part ff_pa(p), b part ff_pb(p)):
// hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi, every one whose bits
// reach 2^-24 of the product; chains run them from the last, smallest
// first
constexpr int FF_PAIRS = 6;
__device__ __forceinline__ int ff_pa(int p) {
  return p == 2 || p == 4 ? 1 : p == 5 ? 2 : 0;
}
__device__ __forceinline__ int ff_pb(int p) {
  return p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0;
}
constexpr int FF_MAX_CHUNKS = 2;   // chunks of a column block, at most
constexpr int FF_QP = FW_ROWS * 128;       // a Q chunk's part, 16 KB
constexpr int FF_KP = FW_BK * 128;         // a K or V chunk's part, 8 KB
constexpr int FF_QPS = FF_MAX_CHUNKS * FF_QP;   // between Q's parts
constexpr int FF_KPS = FF_MAX_CHUNKS * FF_KP;   // between K's or V's parts
constexpr int FF_ITEMS = FW_ROWS * FW_BK / 4;   // float4s of the partials
// shared memory: Q in parts (96 KB); K in parts, which is also the
// exchange between a tile's partial product and the next tile's K (48
// KB); V in parts (48 KB); float32 slots of one chunk of 128 rows (32
// KB); 1024 bytes to align: 225 KB (at Dh 128, FF_ONE, all of it holds
// the head's tiles: 227 KB is what binds the design)
constexpr int FF_QB = FF_PARTS * FF_QPS;
constexpr int FF_KB = FF_PARTS * FF_KPS > FF_ITEMS * 16 ? FF_PARTS * FF_KPS
                                                        : FF_ITEMS * 16;
constexpr int FF_VB = FF_PARTS * FF_KPS;
constexpr int FF_SMEM_BYTES = FF_QB + FF_KB + FF_VB + FW_ROWS * FW_CHUNK * 4
                            + 1024;
static_assert(FF_SMEM_BYTES <= SMEM_OPTIN_BYTES,
              "flash fwd hf: tiles exceed the shared memory of a block");

// (u, v) = hi + mid + lo, bf16 pairs that hold every bit of both (each
// remainder is exact), as csrc/ssd_scan_bwd.cu splits: w[q] packs part q
__device__ __forceinline__ void split3(float u, float v, uint32_t w[FF_PARTS]) {
#pragma unroll
  for (int q = 0; q < FF_PARTS; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
    w[q] = *reinterpret_cast<const uint32_t*>(&h);
    u -= __low2float(h);
    v -= __high2float(h);
  }
}
// rows [r0, r0 + ROWS) of the 64-column chunk `ch` of head `hd` of a (B, S,
// heads, dh) float32 tensor into float32 slots `f` by cp.async: thread t
// copies float4s t + 256 i (row (t + 256 i) / 16, columns 4 ((t + 256 i) %
// 16) + 0..3), rows >= S zeros.  cp.async cannot split; each thread splits
// its own slots (ff_split), so the slots need no barrier
template <int ROWS>
__device__ __forceinline__ void ff_copy(float4* f, const void* src, int b,
                                        int S, int heads, int hd, int r0,
                                        int dh, int ch) {
  const float* base = static_cast<const float*>(src)
      + (size_t(b) * S * heads + hd) * dh + FW_CHUNK * ch;
#pragma unroll
  for (int i = 0; i < ROWS / 16; ++i) {
    const int idx = threadIdx.x + 256 * i, t = r0 + idx / 16;
    const bool in = t < S;
    cp_async16(f + idx, base + size_t(in ? t : 0) * heads * dh
                            + 4 * (idx % 16), in ? 16 : 0);
  }
}
// this thread's slots of `f` (landed) split into the three parts of a
// swizzled chunk tile of ROWS rows (part q at dst + q `ps`)
template <int ROWS>
__device__ __forceinline__ void ff_split(unsigned char* dst, const float4* f,
                                         int ps) {
#pragma unroll 1                   // one float4 at a time: it runs beside a
  for (int i = 0; i < ROWS / 16; ++i) {   // chain that holds most registers
    const int idx = threadIdx.x + 256 * i, r = idx / 16, c4 = idx % 16;
    const float4 v = f[idx];
    uint32_t lo[FF_PARTS], hi[FF_PARTS];
    split3(v.x, v.y, lo);
    split3(v.z, v.w, hi);
    unsigned char* d = dst + fw_swz<ROWS>(r, c4 >> 1) + 8 * (c4 & 1);
#pragma unroll
    for (int q = 0; q < FF_PARTS; ++q)
      *reinterpret_cast<uint2*>(d + q * ps) = make_uint2(lo[q], hi[q]);
  }
  asm volatile("" ::: "memory");   // the slots are read before new copies
}
// d (the warpgroup's 64 x 64 scores, accumulator order) = q . k^T over NC
// chunks: q the warpgroup's 64 rows of the Q chunks, k the K chunks, both
// K-major in three parts; the part products smallest first, one wgmma
// chain, committed (wait with ff_wait)
// (the pairs a runtime loop, each descriptor its tile's plus an offset in
// 16-byte units: the unrolled chain's descriptors, hoisted, held ~100
// registers)
template <int NC>
__device__ __forceinline__ void ff_scores(float d[32], const unsigned char* q,
                                          const unsigned char* k) {
  const uint64_t dq = sw128_desc(q), dk = sw128_desc(k);
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
  for (int p = FF_PAIRS - 1; p >= 0; --p) {
    const uint64_t qa = dq + ff_pa(p) * (FF_QPS >> 4);
    const uint64_t kb = dk + ff_pb(p) * (FF_KPS >> 4);
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk)
      wgmma_64x64(d, qa + (((kk >> 2) * FF_QP + (kk & 3) * 32) >> 4),
                  kb + (((kk >> 2) * FF_KP + (kk & 3) * 32) >> 4),
                  p < FF_PAIRS - 1 || kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// P's float32 scores (accumulator order) split into three parts of
// register-A fragments (score n-tiles 2 kk and 2 kk + 1 make k-step kk)
__device__ __forceinline__ void ff_frags(uint32_t f[FF_PARTS][4][4],
                                         const float s[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t w[FF_PARTS];
      split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], w);
#pragma unroll
      for (int q = 0; q < FF_PARTS; ++q) f[q][kk][r] = w[q];
    }
}
// d (the warpgroup's 64 x 64, from zero) = P . v: P's fragments f, v one V
// chunk read MN-major in three parts; the part products smallest first,
// one register-A chain, committed (wait with ff_wait)
__device__ __forceinline__ void ff_pv(float d[32],
                                      const uint32_t f[FF_PARTS][4][4],
                                      const unsigned char* v) {
  const uint64_t dv = mn_desc(v);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int p = FF_PAIRS - 1; p >= 0; --p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64>(d, f[ff_pa(p)][kk],
                   dv + ((ff_pb(p) * FF_KPS + kk * 16 * 128) >> 4));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ff_wait(float d[32]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
}
// acc (chunk c's 32 floats at acc + 32 c) += P V over the block's NC
// chunks of V, one chain a chunk, each summed from zero (and added if the
// tile is `live`)
template <int NC>
__device__ __forceinline__ void ff_accumulate(float* acc,
                                              const uint32_t f[FF_PARTS][4][4],
                                              const unsigned char* v,
                                              bool live) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float tmp[32];
    ff_pv(tmp, f, v + c * FF_KP);
    ff_wait(tmp);
    if (live)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[32 * c + e] += tmp[e];
  }
}

// o = acc / max(l, 1e-30) over the block's NC chunks (from ch0), float32,
// and (column block 0) the row lse = m ln 2 + log l
template <int NC>
__device__ __forceinline__ void ff_store(const FlashArgs& a, const FwArgs& x,
                                         const FwPlace& p, const float* acc,
                                         float m[2], float l[2], int cb,
                                         int ch0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? p.row1 : p.row0;
    if (qi >= a.Sq) continue;
    if (a.lse && p.t4 == 0 && cb == 0)     // the quad holds the row's m, l
      a.lse[(size_t(p.b) * a.H + p.h) * a.Sq + qi] =
          (m[r] == NEG_INF ? NEG_INF : m[r] * LN2) + logf(l[r]);
    const float den = fmaxf(l[r], 1e-30f);
    float* row = static_cast<float*>(a.o)
        + ((size_t(p.b) * a.Sq + qi) * a.H + p.h) * x.dh + FW_CHUNK * ch0;
#pragma unroll
    for (int j = 0; j < 8 * NC; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * p.t4) =
          make_float2(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
  }
}

// the block's NC chunks (from ch0) of rows [r0, r0 + FW_BK) of a K or V
// tensor through the slots into the parts at dst
template <int NC>
__device__ __forceinline__ void ff_copy_kv(float4* slots, const void* src,
                                           const FlashArgs& a,
                                           const FwPlace& p, const FwArgs& x,
                                           int r0, int ch0) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    ff_copy<FW_BK>(slots + c * (FF_ITEMS / 2), src, p.b, a.Sk, a.KvH, p.kvh,
                   r0, x.dh, ch0 + c);
}
template <int NC>
__device__ __forceinline__ void ff_split_kv(unsigned char* dst,
                                            const float4* slots) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    ff_split<FW_BK>(dst + c * FF_KP, slots + c * (FF_ITEMS / 2), FF_KPS);
}
// the block's Q chunks (128 rows), one at a time through the slots
template <int NC>
__device__ __forceinline__ void ff_stage_q(unsigned char* sm, float4* slots,
                                           const FlashArgs& a,
                                           const FwPlace& p, const FwArgs& x,
                                           int ch0) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    ff_copy<FW_ROWS>(slots, a.q, p.b, a.Sq, a.H, p.h, p.q0, x.dh, ch0 + c);
    cp_async_commit();
    cp_async_wait<0>();
    ff_split<FW_ROWS>(sm + c * FF_QP, slots, FF_QPS);
  }
}

// the cluster's exchange of ff_cluster's tile (the K tile, read by now):
// the warpgroup's partial s published in the block's exchange; a cluster
// barrier; the owner of each item of [lo, hi) sums the ranks' partials in
// rank order and writes the total in its place in every block's exchange;
// a cluster barrier; s read back (the scores) where the tile is `live`
__device__ __forceinline__ void ff_exchange(float s[32], float4* xch,
                                            const FwArgs& x, int cb, int lo,
                                            int hi, bool live, int wg) {
  const int wt = threadIdx.x % 128;
  __syncthreads();                 // K_i read: the tile is the exchange
  if (live)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      xch[wg * 1024 + j * 128 + wt] =
          make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  cluster_arrive();
  cluster_wait();                  // the partials are published
  for (int pos = lo + threadIdx.x; pos < hi; pos += 256) {
    float4 t[FW_CLUSTER];
#pragma unroll
    for (int r = 0; r < FW_CLUSTER; ++r)
      if (r < x.ranks) t[r] = (r == cb ? xch : peer(xch, r))[pos];
#pragma unroll
    for (int r = 1; r < FW_CLUSTER; ++r)
      if (r < x.ranks) {
        t[0].x += t[r].x; t[0].y += t[r].y; t[0].z += t[r].z;
        t[0].w += t[r].w;
      }
#pragma unroll
    for (int r = 0; r < FW_CLUSTER; ++r)
      if (r < x.ranks)
        (r == cb ? xch : const_cast<float4*>(peer(xch, r)))[pos] = t[0];
  }
  cluster_arrive();
  cluster_wait();                  // every owner's totals are in place
  if (live)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = xch[wg * 1024 + j * 128 + wt];
      s[4 * j] = v.x; s[4 * j + 1] = v.y; s[4 * j + 2] = v.z;
      s[4 * j + 3] = v.w;
    }
}

// column block cb (NC chunks) of one (128-row query tile, head, batch) in a
// cluster of `ranks` blocks.  Kv tile i's step: each warpgroup's partial
// S_c = Q_c K_c^T (while it runs, V_i is split in and K_{i+1} copied to
// the slots); the K tile becomes the exchange: each warpgroup publishes
// its partial there; a cluster barrier; the owner of each run of the
// exchange's items sums the ranks' partials in rank order and writes the
// totals in their place in every block's exchange; a cluster barrier;
// each warpgroup reads its scores from its own exchange, runs the online
// softmax in float32 and adds P V_c, each chunk's product summed from
// zero (while the first runs, K_{i+1} is split in and V_{i+1} copied).
// The next publish writes only the block's own exchange, which no block
// touches between the second barrier and the next first one: two barrier
// phases a tile.  ONE: the head is this block's one column block (Dh 64
// or 128), so its partial is S: no exchange and no cluster barrier, two
// block barriers a tile (K_i split in; V_i split in and K_i read)
template <int NC, bool ONE>
__device__ __forceinline__ void ff_cluster(const FlashArgs& a,
                                           const FwArgs& x,
                                           unsigned char* sm, int cb) {
  const FwPlace p(a, x);
  const int n = p.kt_end - p.kt_begin;
  const int ch0 = cb * x.nch / x.ncb;
  const unsigned char* qw = sm + p.wg * 64 * 128;  // the warpgroup's Q rows
  unsigned char* ks = sm + FF_QB;                  // K, or the exchange
  unsigned char* vs = ks + FF_KB;
  float4* xch = reinterpret_cast<float4*>(ks);
  float4* slots = reinterpret_cast<float4*>(vs + FF_VB);
  auto k0 = [&](int i) { return (p.kt_begin + i) * FW_BK; };
  const float sl2 = a.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) acc[i] = 0.f;
  if (n > 0) {
    ff_stage_q<NC>(sm, slots, a, p, x, ch0);
    ff_copy_kv<NC>(slots, a.k, a, p, x, k0(0), ch0);
    cp_async_commit();
    cp_async_wait<0>();
    ff_split_kv<NC>(ks, slots);
    ff_copy_kv<NC>(slots, a.v, a, p, x, k0(0), ch0);
    cp_async_commit();
  }
  // the run of items this block owns
  const int lo = (cb * FF_ITEMS + x.ranks - 1) / x.ranks;
  const int hi = ((cb + 1) * FF_ITEMS + x.ranks - 1) / x.ranks;

  for (int i = 0; i < n; ++i) {
    const int kt = p.kt_begin + i;
    const bool live = p.live(a, kt);
    fence_proxy_async();           // K_i split in is visible to wgmma, for
    __syncthreads();               // every thread; tile i - 1 done
    // the products run whether the tile is live or not: a wgmma chain
    // across a branch is serialized
    float s[32];
    ff_scores<NC>(s, qw, ks);
    cp_async_wait<0>();            // V_i's slots have landed
    ff_split_kv<NC>(vs, slots);
    if (i + 1 < n) ff_copy_kv<NC>(slots, a.k, a, p, x, k0(i + 1), ch0);
    cp_async_commit();
    ff_wait(s);
    if constexpr (!ONE) ff_exchange(s, xch, x, cb, lo, hi, live, p.wg);
    if (live) fw_softmax<NC>(s, m, l, acc, a, p, sl2, kt);
    fence_proxy_async();           // V_i split in is visible to wgmma;
    __syncthreads();               // every thread has read the exchange
    uint32_t f[FF_PARTS][4][4];
    float tmp[32];
    ff_frags(f, s);
    ff_pv(tmp, f, vs);
    if (i + 1 < n) {               // K_{i+1} in, V_{i+1} to the slots
      cp_async_wait<0>();
      ff_split_kv<NC>(ks, slots);
      ff_copy_kv<NC>(slots, a.v, a, p, x, k0(i + 1), ch0);
    }
    cp_async_commit();
    ff_wait(tmp);
    if constexpr (NC > 1) ff_accumulate<NC - 1>(acc + 32, f, vs + FF_KP,
                                                live);
    if (live)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += tmp[e];
  }
  cp_async_wait<0>();              // nothing in flight at exit
  ff_store<NC>(a, x, p, acc, m, l, cb, ch0);
}

// column block cb (NC chunks) without a cluster (more blocks than a
// cluster holds): per kv tile, S over the whole head, one chunk of Q and K
// after another staged and multiplied, each chunk's product summed from
// zero and added in float32 in chunk order (so every block holds the same
// S), then acc += P V_c
template <int NC>
__device__ __forceinline__ void ff_solo(const FlashArgs& a, const FwArgs& x,
                                        unsigned char* sm, int cb) {
  const FwPlace p(a, x);
  const int ch0 = cb * x.nch / x.ncb;
  const unsigned char* qw = sm + p.wg * 64 * 128;
  unsigned char* ks = sm + FF_QB;
  unsigned char* vs = ks + FF_KB;
  float4* slots = reinterpret_cast<float4*>(vs + FF_VB);
  const float sl2 = a.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) acc[i] = 0.f;

  for (int kt = p.kt_begin; kt < p.kt_end; ++kt) {
    const bool live = p.live(a, kt);
    float s[32], tmp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int c = 0; c < x.nch; ++c) {
      __syncthreads();             // the last chunk's readers are done
      ff_copy<FW_ROWS>(slots, a.q, p.b, a.Sq, a.H, p.h, p.q0, x.dh, c);
      cp_async_commit();
      cp_async_wait<0>();
      ff_split<FW_ROWS>(sm, slots, FF_QPS);
      ff_copy_kv<1>(slots, a.k, a, p, x, kt * FW_BK, c);
      cp_async_commit();
      cp_async_wait<0>();
      ff_split_kv<1>(ks, slots);
      if (c == 0) {
        ff_copy_kv<NC>(slots, a.v, a, p, x, kt * FW_BK, ch0);
        cp_async_commit();
        cp_async_wait<0>();
        ff_split_kv<NC>(vs, slots);
      }
      fence_proxy_async();
      __syncthreads();
      ff_scores<1>(tmp, qw, ks);
      ff_wait(tmp);
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] += tmp[e];
    }
    if (live) fw_softmax<NC>(s, m, l, acc, a, p, sl2, kt);
    uint32_t f[FF_PARTS][4][4];
    ff_frags(f, s);
    ff_accumulate<NC>(acc, f, vs, live);
  }
  ff_store<NC>(a, x, p, acc, m, l, cb, ch0);
}

// how a float32 block finds its scores: summed over its cluster's
// partials; alone, the head being its one column block (Dh 64, 128);
// over the whole head, one chunk after another (past a cluster)
enum FfMode { FF_CLUSTER = 0, FF_ONE = 1, FF_SOLO = 2 };

template <int NC, int MODE>
__device__ __forceinline__ void ff_block(const FlashArgs& a, const FwArgs& x,
                                         unsigned char* sm, int cb) {
  if constexpr (MODE == FF_SOLO) ff_solo<NC>(a, x, sm, cb);
  else ff_cluster<NC, MODE == FF_ONE>(a, x, sm, cb);
}

// flash_fwd_hw's grid, column blocks of one or two chunks; an instance a
// mode (FfMode), so that no wgmma chain spans a branch on it
template <int MODE>
__global__ void __launch_bounds__(256, 1) flash_fwd_hf(FlashArgs a,
                                                       FwArgs x) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  const int cb = blockIdx.x % x.ncb;
  if ((cb + 1) * x.nch / x.ncb - cb * x.nch / x.ncb == 2)
    ff_block<2, MODE>(a, x, sm, cb);
  else
    ff_block<1, MODE>(a, x, sm, cb);
}

// grid (ncb B H, query tiles), clusters of the ncb column blocks (ncb <=
// FW_CLUSTER), else none.  bf16: flash_fwd_hw, column blocks of 2-4
// chunks (Dh > 256); float32: flash_fwd_hf, of 1-2 (every multiple of 64:
// one block alone at Dh 64 and 128, a cluster of 2 at Dh 256)
int launch_fwd_wide(const FlashArgs& a, int dh, bool bf16, cudaStream_t s) {
  const int nch = dh / FW_CHUNK;
  const int chunks = bf16 ? FW_MAX_CHUNKS : FF_MAX_CHUNKS;
  FwArgs x{dh, nch, (nch + chunks - 1) / chunks, 0};
  x.ranks = x.ncb <= FW_CLUSTER ? x.ncb : 1;
  void (*kernel)(FlashArgs, FwArgs) =
      bf16 ? flash_fwd_hw
      : x.ncb == 1 ? flash_fwd_hf<FF_ONE>
      : x.ranks > 1 ? flash_fwd_hf<FF_CLUSTER> : flash_fwd_hf<FF_SOLO>;
  const int smem = bf16 ? FW_SMEM_BYTES : FF_SMEM_BYTES;
  const int nq = (a.Sq + FW_ROWS - 1) / FW_ROWS;
  const size_t nx = size_t(x.ncb) * a.B * a.H;
  if (nq > 65535 || nx > 0x7fffffffu) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(nx), unsigned(nq));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(x.ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, x);
  return int(err != cudaSuccess ? err : cudaGetLastError());
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
  if (dtype == 1) {
    switch (Dh) {
      case 64: return launch_bf16<64>(a, s);
      case 96: return launch_bf16<96>(a, s);
      case 128: return launch_bf16<128>(a, s);
      case 256: return launch_bf16<256>(a, s);
    }
  }
  // float32 at every multiple of 64 (the wrapper pads Dh 96 to 128), bf16
  // past 256
  if (Dh > 0 && Dh % FW_CHUNK == 0 && (dtype == 0 || (dtype == 1 && Dh > 256)))
    return launch_fwd_wide(a, Dh, dtype == 1, s);
  return int(cudaErrorInvalidValue);
}

#endif
