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
// o = acc / max(l, 1e-30) in q's dtype.  Every kernel here folds the
// scale into log2 units and takes p = 2^(s scale log2e - m) by ex2.approx
// (relative error ~2^-22, before P's rounding to bf16 in bf16), m in log2
// units and the lse m ln 2 + log l.
//
// What bounds it: at the slice's shape (B = 2, S = 4096, H = 32, Dh = 64,
// causal, bf16) the work is ~137 GFLOP of products against ~134 MB of
// traffic, so it is bound by operations: ~0.14 ms at the bf16 tensor-core
// peak.
//
// bfloat16 at Dh 64, 96, 128 and 256 (flash_fwd_hb): Hopper's usual shape
// of a fast kernel.  A block owns 128 query rows of one (batch, head) in
// three warpgroups: warpgroup 0 the producer (setmaxnreg down to 40
// registers), whose one thread copies Q once and the K and V tiles by TMA
// (a CUtensorMap per tensor, built on the host each call and passed as a
// __grid_constant__ parameter; rows past Sq or Sk land as zeros) through
// rings of two stages with full / empty mbarriers; warpgroups 1 and 2 the
// consumers (up to 232 registers), 64 query rows each.  kv tiles are 128
// keys up to Dh 128 and 64 at Dh 256 (registers: S and the accumulator
// hold 128 floats a thread there; shared memory: Q 64 KB and two stages of
// K and V 128 KB).  Tiles lie in the 128-byte swizzle that wgmma reads,
// 64-column chunks; Dh 96 is native, its second chunk's upper 32 columns
// zero-filled by TMA (out of bounds) and never read: S over 6 k-steps, P V
// one N 96 product (a 32-column chunk in the 64-byte swizzle, read by N 64
// + N 32 products, read no faster).  S = Q K^T is a wgmma chain of
// shared-memory operands (m64nBKk16, both K-major); P V takes P as the
// register A operand, packed to bf16 from the S accumulators as they lie,
// V read MN-major.  A consumer's step (tile i):
// S_i and P_{i-1} V_{i-1} issued in its turn, the turn handed to the other
// consumer (named barriers), the softmax of S_i while P V runs, then the
// rescale and P_i's packing; so one consumer's softmax runs while the
// other's products do.  Inside the masks' edges the scale and the shift by
// m are one fma, and the row max and sum run in four partial chains; masks
// run only on tiles that cross the diagonal, the window's edge or Sk, and
// a tile wholly masked for a consumer's 64 rows is released unread (a row
// sees keys only from the first tile it visits on); the walk begins at the
// window's first tile and blocks start with the heaviest causal query
// tiles.  What each part buys, and where the time goes, is read by
// scripts/kernel_probe.py flash-bf16-variants (PERF.md): at Dh 64 the
// softmax (an MUFU ex2 a score, one warp of each consumer a scheduler) is
// the critical path, the products nearly free beside it.  No atomics: a
// call repeats bit for bit, and a launch with the lse writes o as one
// without.
// ptxas (sm_90a): 168 registers at launch at every width (the consumers'
// 232 after setmaxnreg), no spill.  It replaces flash_kernel_bf16
// (mma.sync m16n8k16 with ldmatrix, FlashAttention-2's layout, 64-key
// tiles by cp.async), which took 2.2-2.7x SDPA's time (H100, PERF.md).
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
// The gradient: when asked (a non-null `lse`), every path also writes each
// query row's log-sum-exp of its scaled, masked scores, m + log l (l the
// sum of the unrounded p), which flash_attention_bwd.cu reads to recompute
// P = exp(s - lse).  Serving passes null: its launches write o alone,
// bit for bit as with the option.
//
// Head widths: bf16 Dh 64, 96, 128 and 256 here (flash_fwd_hb), float32
// any multiple of 64.  static_asserts refuse a bf16 width the tiles do not
// hold and tiles that would not fit the 227 KB of shared memory a block may
// opt into.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
// The softmax keeps the built widths' masks and tile skipping, per
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

// ---------------------------------------------------------------------------
// bfloat16 at the built widths (Dh 64, 96, 128, 256): flash_fwd_hb
// ---------------------------------------------------------------------------

constexpr int HB_ROWS = 128;       // query rows of a block: two warpgroups
constexpr int HB_THREADS = 384;    // the producer warpgroup and two consumers
// registers a thread after setmaxnreg: the producer gives up what the
// consumers take (128 x 40 + 256 x 232 <= 65 536)
constexpr int HB_PRODUCER_REGS = 40, HB_CONSUMER_REGS = 232;
// the design's parts, each a switch that scripts/kernel_probe.py's
// flash-bf16-variants turns off in turn: tiles copied by TMA (else by the
// producer warpgroup's cp.async), S of kv tile j + 1 and P V of tile j in
// flight while tile j + 1's softmax runs (else one product at a time), the
// two consumers issuing their products in turns (else as they come), p by
// ex2.approx with the scale folded into log2 units (else expf), the scale
// and the shift by m in one fma inside the masks' edges (else two steps)
constexpr bool HB_TMA = true;
constexpr bool HB_OVERLAP = true;
constexpr bool HB_PINGPONG = true;
constexpr bool HB_EXP2 = true;
constexpr bool HB_FOLD = true;
// keys of a kv tile: 128 up to Dh 128, 64 at Dh 256 (registers and shared
// memory)
__host__ __device__ constexpr int hb_bk(int dh) {
  return dh <= 128 ? 128 : 64;
}
// K and V tiles in flight, each (three up to Dh 128 read no faster)
__host__ __device__ constexpr int hb_stages(int) { return 2; }

// a tile of rows of one head, bf16, as wgmma reads it: the head's
// 64-column chunks, each rows x 128 bytes in the 128-byte swizzle; at Dh
// 96 the second chunk's upper 32 columns are zeros (TMA fills columns past
// the head's with zeros), read by no product
template <int DH>
struct HbTile {
  static constexpr int BK = hb_bk(DH);
  static constexpr int STAGES = hb_stages(DH);
  static constexpr int FULL = (DH + 63) / 64;    // 64-column chunks
  static constexpr int QB = HB_ROWS * 128 * FULL;   // the Q tile's bytes
  static constexpr int KB = BK * 128 * FULL;     // a K or V tile's
  // barriers: Q full; K full, V full, K empty, V empty a stage
  static constexpr int BARS = 1 + 4 * STAGES;
  // Q, the stages of K and of V, the barriers, 1024 bytes to align
  static constexpr int SMEM = QB + 2 * STAGES * KB + 8 * BARS + 1024;
  static_assert(DH % 32 == 0 && DH > 0 && DH <= 256,
                "flash fwd hb: a width of 32-column steps up to 256");
  static_assert(SMEM <= SMEM_OPTIN_BYTES,
                "flash fwd hb: tiles exceed the shared memory of a block");
};

// an MN-major tile in the 128-byte swizzle whose 64-column chunks lie
// `lbo` bytes apart (1024 bytes between 8-row groups)
__device__ __forceinline__ uint64_t mn128_desc(const void* p, int lbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16)
       | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// d (64 x N f32, the warpgroup's) = [d +] a (64 x 16) . b (N x 16)^T, both
// bf16 K-major in shared memory
template <int N>
__device__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  wgmma_64x64(d, da, db, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                              uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
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

// ---- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// one arrival that also expects `bytes` of copies to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// returns once the phase of parity `parity` has completed
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
// TMA: the box at (column, head, row, batch) of `map` into `dst`, its
// bytes reported to `bar`; rows past the tensor's end land as zeros
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

// the tensors' TMA maps: boxes of 64 columns in the 128-byte swizzle
struct HbMaps {
  CUtensorMap q, k, v;
};

// rows [r0, r0 + ROWS) of head `hd` of batch b into a tile (HbTile's
// layout), reported to `bar`
template <int DH, int ROWS>
__device__ __forceinline__ void hb_tma_tile(unsigned char* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int b, int hd,
                                            int r0) {
#pragma unroll
  for (int c = 0; c < HbTile<DH>::FULL; ++c)
    tma_load(dst + c * ROWS * 128, map, bar, 64 * c, hd, r0, b);
}
// the same by cp.async, the producer warpgroup's 128 threads each copying
// 16-byte pieces into their swizzled places (rows >= S zeros; at Dh 96 the
// second chunk's upper half is left as it is: no product reads it)
template <int DH, int ROWS>
__device__ __forceinline__ void hb_cp_tile(unsigned char* dst,
                                           const void* src, int b, int S,
                                           int heads, int hd, int r0) {
  constexpr int P = DH / 8;                        // pieces a row
  for (int idx = threadIdx.x; idx < ROWS * P; idx += 128) {
    const int r = idx / P, c = idx % P, t = r0 + r;
    const bool in = t < S;
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(src)
        + ((size_t(b) * S + (in ? t : 0)) * heads + hd) * DH + 8 * c;
    cp_async16(dst + (c >> 3) * ROWS * 128 + r * 128
                   + (((c & 7) ^ (r & 7)) << 4), g, in ? 16 : 0);
  }
}

// the block's barriers and tiles in shared memory
template <int DH>
struct HbSmem {
  unsigned char *q, *k, *v;        // Q; stage st of K at k + st KB, of V
  uint64_t *q_full, *k_full, *v_full, *k_empty, *v_empty;
  __device__ explicit HbSmem(unsigned char* sm) {
    using T = HbTile<DH>;
    q = sm;
    k = q + T::QB;
    v = k + T::STAGES * T::KB;
    q_full = reinterpret_cast<uint64_t*>(v + T::STAGES * T::KB);
    k_full = q_full + 1;
    v_full = k_full + T::STAGES;
    k_empty = v_full + T::STAGES;
    v_empty = k_empty + T::STAGES;
  }
};

// the producer (one thread; every thread of warpgroup 0 without TMA): Q
// once, then K and V of the block's kv tiles [kt_begin, kt_begin + n),
// each into its ring's next stage once both consumers have released it
template <int DH>
__device__ __forceinline__ void hb_produce(const HbMaps& maps,
                                           const FlashArgs& a,
                                           const HbSmem<DH>& sm, int b,
                                           int h, int kvh, int q0,
                                           int kt_begin, int n) {
  using T = HbTile<DH>;
  if constexpr (HB_TMA) {
    mbar_expect(sm.q_full, T::QB);
    hb_tma_tile<DH, HB_ROWS>(sm.q, &maps.q, sm.q_full, b, h, q0);
    for (int i = 0; i < n; ++i) {
      const int st = i % T::STAGES, r0 = (kt_begin + i) * T::BK;
      const uint32_t free = ((i / T::STAGES) & 1) ^ 1;
      mbar_wait(sm.k_empty + st, free);
      mbar_expect(sm.k_full + st, T::KB);
      hb_tma_tile<DH, T::BK>(sm.k + st * T::KB, &maps.k, sm.k_full + st, b,
                             kvh, r0);
      mbar_wait(sm.v_empty + st, free);
      mbar_expect(sm.v_full + st, T::KB);
      hb_tma_tile<DH, T::BK>(sm.v + st * T::KB, &maps.v, sm.v_full + st, b,
                             kvh, r0);
    }
    mbar_wait(sm.q_full, 0);       // Q has landed before the thread leaves
  } else {
    // one copy group in flight: load L's copies are issued, then load L -
    // 1's waited for, made visible to wgmma and reported
    uint64_t* last = sm.q_full;
    hb_cp_tile<DH, HB_ROWS>(sm.q, a.q, b, a.Sq, a.H, h, q0);
    cp_async_commit();
    auto step = [&](uint64_t* empty, uint32_t free, unsigned char* dst,
                    const void* src, int r0, uint64_t* full) {
      mbar_wait(empty, free);
      hb_cp_tile<DH, T::BK>(dst, src, b, a.Sk, a.KvH, kvh, r0);
      cp_async_commit();
      cp_async_wait<1>();
      fence_proxy_async();
      mbar_arrive(last);
      last = full;
    };
    for (int i = 0; i < n; ++i) {
      const int st = i % T::STAGES, r0 = (kt_begin + i) * T::BK;
      const uint32_t free = ((i / T::STAGES) & 1) ^ 1;
      step(sm.k_empty + st, free, sm.k + st * T::KB, a.k, r0,
           sm.k_full + st);
      step(sm.v_empty + st, free, sm.v + st * T::KB, a.v, r0,
           sm.v_full + st);
    }
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(last);
  }
}

// S = Q K^T for the warpgroup's 64 rows (from row `qr` of the Q tile q)
// and one K tile k of BK keys: a wgmma chain over Dh / 16 k-steps,
// committed
template <int DH>
__device__ __forceinline__ void hb_scores(float* s, const unsigned char* q,
                                          int qr, const unsigned char* k) {
  using T = HbTile<DH>;
  fence_acc<T::BK / 2>(s);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {   // chunk kk / 4, its k-step
    const int c = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss<T::BK>(s, sw128_desc(q + c * HB_ROWS * 128 + qr * 128 + off),
                    sw128_desc(k + c * T::BK * 128 + off), kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps P's fragments in their registers until the product that reads
// them has been waited for
template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
}

// acc (the warpgroup's 64 x Dh f32) += P (64 x BK bf16: BK / 16 k-steps of
// register fragments) . V (one tile, read MN-major): one register-A wgmma
// chain, committed; up to 128 columns (two chunks) in one product
template <int DH>
__device__ __forceinline__ void hb_pv(float* acc, uint32_t (*pa)[4],
                                      const unsigned char* v) {
  using T = HbTile<DH>;
  constexpr int CB = T::BK * 128;  // bytes between the 64-column chunks
  fence_acc<DH / 2>(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    const unsigned char* rows = v + kk * 16 * 128;
    if constexpr (DH > 128) {
      wgmma_rs<128>(acc, pa[kk], mn128_desc(rows, CB));
      wgmma_rs<DH - 128>(acc + 64, pa[kk], mn128_desc(rows + 2 * CB, CB));
    } else {
      wgmma_rs<DH>(acc, pa[kk], mn128_desc(rows, CB));
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float hb_exp(float x) {
  return HB_EXP2 ? fw_exp2(x) : expf(x);
}

// a consumer thread's rows: the warpgroup's 64 [r_first, r_last], the
// thread's two (row0, row1) and its column pair t4
struct HbRows {
  int r_first, r_last, row0, row1, t4, lane;
};

// kv tile kt's scores s (the warpgroup's, accumulator order) into P: the
// online softmax on the thread's two rows, scaled by sc (into log2 units
// with ex2): m, l (its part of the row sum of the unrounded p) and alpha,
// the factor the accumulator is to be rescaled by; P left in s, float32.
// A tile that crosses an edge is scaled, masked, and p = exp(s sc - m); a
// tile inside them takes the row max of s unscaled (sc > 0, so max(s) sc
// rounds to the max of the scaled scores) and p = exp(fma(s, sc, -m)), one
// instruction for the scale and the shift.  The row max and sum run in
// four partial chains
template <int BK>
__device__ __forceinline__ void hb_softmax(float* s, float m[2], float l[2],
                                           float alpha[2], const FlashArgs& a,
                                           const HbRows& w, float sc, int kt) {
  const int k0 = kt * BK;
  bool edge = k0 + BK > a.Sk;
  if (a.causal) edge = edge || k0 + BK - 1 > w.r_first;
  if (a.window >= 0) edge = edge || k0 <= w.r_last - a.window;
  const bool fold = HB_FOLD && !edge && sc > 0.f;
  if (!fold) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[4 * j + e] * sc;
        if (edge) {
          const int kj = k0 + 8 * j + 2 * w.t4 + (e & 1);
          const int qi = e < 2 ? w.row0 : w.row1;
          bool ok = kj < a.Sk;
          if (a.causal) ok = ok && kj <= qi;
          if (a.window >= 0) ok = ok && kj > qi - a.window;
          if (!ok) v = NEG_INF;
        }
        s[4 * j + e] = v;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mp[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mp[j % 4] = fmaxf(mp[j % 4],
                        fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    float mx = fmaxf(fmaxf(mp[0], mp[1]), fmaxf(mp[2], mp[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], fold ? mx * sc : mx);
    alpha[r] = hb_exp(m[r] - m_new);
    m[r] = m_new;
    float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        x = hb_exp(fold ? __fmaf_rn(x, sc, -m_new) : x - m_new);
        sp[j % 4] += x;
      }
    l[r] = l[r] * alpha[r] + ((sp[0] + sp[1]) + (sp[2] + sp[3]));
  }
}
template <int DH>
__device__ __forceinline__ void hb_rescale(float* acc, const float alpha[2]) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}
// P rounded to bf16 as k-step fragments (score n-tiles 2 kk and 2 kk + 1
// make k-step kk)
template <int BK>
__device__ __forceinline__ void hb_pack(uint32_t (*pa)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// o = acc / max(l, 1e-30) in bf16 and, when asked, the row lse (m ln 2 +
// log l with ex2)
template <int DH>
__device__ __forceinline__ void hb_store(const FlashArgs& a, const HbRows& w,
                                         int b, int h, const float* acc,
                                         const float m[2], float l[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? w.row1 : w.row0;
    if (qi >= a.Sq) continue;
    if (a.lse && w.t4 == 0)        // the quad holds the row's m and l
      a.lse[(size_t(b) * a.H + h) * a.Sq + qi] =
          (HB_EXP2 && m[r] != NEG_INF ? m[r] * LN2 : m[r]) + logf(l[r]);
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* row = static_cast<__nv_bfloat16*>(a.o)
        + ((size_t(b) * a.Sq + qi) * a.H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * w.t4) =
          pack_bf16(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
  }
}

// a consumer warpgroup (1 or 2: query rows 64 (wg - 1) on of the block's
// 128) over the block's n kv tiles from kt_begin.  The tiles [lo, hi)
// reach its rows; the others are wholly masked for them and change
// nothing (a row sees keys only from the first tile it visits on), so it
// releases them as they land.  Tile i's step with the overlap:
//   [its turn] S_i = Q K_i^T issued -> P_{i-1} V_{i-1} issued [the other
//   consumer's turn] -> wait for S_i, release K_i -> the softmax of S_i ->
//   wait for the PV product, release V_{i-1} -> acc *= alpha_i -> P_i
//   packed to bf16 fragments
// (without it, each product is issued and waited for in turn).  The turns
// (named barriers 1 and 2, one a consumer) alternate the consumers' issues
// tile by tile, so that one's softmax runs while the other's products do;
// each consumer takes one turn a tile of the block, those it skips too,
// and warpgroup 1 the first.
template <int DH>
__device__ __forceinline__ void hb_consume(const FlashArgs& a,
                                           const HbSmem<DH>& sm, int b,
                                           int h, int q0, int kt_begin,
                                           int n) {
  using T = HbTile<DH>;
  constexpr int BK = T::BK;
  const int wt = threadIdx.x % 128, qr = (threadIdx.x / 128 - 1) * 64;
  HbRows w;
  w.lane = wt % 32;
  w.r_first = q0 + qr;
  w.r_last = w.r_first + 63;
  w.row0 = w.r_first + 16 * (wt / 32) + w.lane / 4;
  w.row1 = w.row0 + 8;
  w.t4 = w.lane % 4;
  int hi = w.r_first < a.Sq ? n : 0;
  if (a.causal) hi = min(hi, max(0, w.r_last / BK + 1 - kt_begin));
  int lo = 0;
  if (a.window >= 0)
    while (lo < hi && (kt_begin + lo) * BK + BK - 1 <= w.r_first - a.window)
      ++lo;
  auto release = [&](uint64_t* empty) {
    if (w.lane == 0) mbar_arrive(empty);
  };
  // its turn to issue tile i's products, and the other's turn after them
  const int me = threadIdx.x / 128;
  auto turn = [&]() {
    if (HB_PINGPONG) asm volatile("bar.sync %0, 256;\n" :: "r"(me) : "memory");
  };
  auto pass = [&](int i) {         // warpgroup 2 keeps its last turn
    if (HB_PINGPONG && (me == 1 || i + 1 < n))
      asm volatile("bar.arrive %0, 256;\n" :: "r"(3 - me) : "memory");
  };
  if (HB_PINGPONG && me == 2 && n > 0) pass(-1);   // warpgroup 1 first
  auto skip = [&](int i) {         // a tile it does not read, once landed
    turn();
    pass(i);
    const int st = i % T::STAGES;
    const uint32_t ph = (i / T::STAGES) & 1;
    mbar_wait(sm.k_full + st, ph);
    release(sm.k_empty + st);
    mbar_wait(sm.v_full + st, ph);
    release(sm.v_empty + st);
  };
  const float sc = HB_EXP2 ? a.scale * LOG2E : a.scale;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t pa[BK / 16][4];

  for (int i = 0; i < lo; ++i) skip(i);
  if (lo < hi) {
    mbar_wait(sm.q_full, 0);
    const int st = lo % T::STAGES;
    mbar_wait(sm.k_full + st, (lo / T::STAGES) & 1);
    turn();
    hb_scores<DH>(s, sm.q, qr, sm.k + st * T::KB);
    pass(lo);
    wgmma_wait<0>();
    fence_acc<BK / 2>(s);
    release(sm.k_empty + st);
    hb_softmax<BK>(s, m, l, alpha, a, w, sc, kt_begin + lo);
    hb_pack<BK>(pa, s);            // acc is zero: nothing to rescale
  }
  for (int i = lo + 1; i < hi; ++i) {
    const int st = i % T::STAGES, pst = (i - 1) % T::STAGES;
    const uint32_t ph = (i / T::STAGES) & 1, pph = ((i - 1) / T::STAGES) & 1;
    if constexpr (HB_OVERLAP) {
      mbar_wait(sm.k_full + st, ph);
      mbar_wait(sm.v_full + pst, pph);
      turn();
      hb_scores<DH>(s, sm.q, qr, sm.k + st * T::KB);
      hb_pv<DH>(acc, pa, sm.v + pst * T::KB);
      pass(i);
      wgmma_wait<1>();             // S_i has landed; P V may still run
      fence_acc<BK / 2>(s);
      release(sm.k_empty + st);
      hb_softmax<BK>(s, m, l, alpha, a, w, sc, kt_begin + i);
      wgmma_wait<0>();
    } else {
      mbar_wait(sm.v_full + pst, pph);
      mbar_wait(sm.k_full + st, ph);
      turn();
      hb_pv<DH>(acc, pa, sm.v + pst * T::KB);
      wgmma_wait<0>();
      hb_scores<DH>(s, sm.q, qr, sm.k + st * T::KB);
      pass(i);
      wgmma_wait<0>();
      fence_acc<BK / 2>(s);
      release(sm.k_empty + st);
      hb_softmax<BK>(s, m, l, alpha, a, w, sc, kt_begin + i);
    }
    fence_acc<DH / 2>(acc);
    fence_frags<BK / 16>(pa);
    release(sm.v_empty + pst);
    hb_rescale<DH>(acc, alpha);
    hb_pack<BK>(pa, s);
  }
  if (lo < hi) {
    const int st = (hi - 1) % T::STAGES;
    mbar_wait(sm.v_full + st, ((hi - 1) / T::STAGES) & 1);
    hb_pv<DH>(acc, pa, sm.v + st * T::KB);
    wgmma_wait<0>();
    fence_acc<DH / 2>(acc);
    release(sm.v_empty + st);
  }
  for (int i = hi; i < n; ++i) skip(i);
  hb_store<DH>(a, w, b, h, acc, m, l);
}

// grid (B H, query tiles of 128 rows, heaviest causal tiles first), 384
// threads: warpgroup 0 the producer, 1 and 2 the consumers
template <int DH>
__global__ void __launch_bounds__(HB_THREADS, 1)
    flash_fwd_hb(const __grid_constant__ HbMaps maps, FlashArgs a) {
  using T = HbTile<DH>;
  extern __shared__ float4 smem4[];
  const HbSmem<DH> sm(reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023)));
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * HB_ROWS;
  // kv tiles the block visits: above the diagonal and before the window
  // of its first row are wholly masked for every row
  int kt_end = (a.Sk + T::BK - 1) / T::BK;
  if (a.causal) kt_end = min(kt_end, (q0 + HB_ROWS - 1) / T::BK + 1);
  int kt_begin = 0;
  if (a.window >= 0) kt_begin = max(0, (q0 - a.window + 1) / T::BK);
  kt_begin = min(kt_begin, kt_end);
  const int n = kt_end - kt_begin;
  if (threadIdx.x == 0) {
    const uint32_t full = HB_TMA ? 1 : 128;   // arrivals that fill a tile
    mbar_init(sm.q_full, full);
#pragma unroll
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(sm.k_full + st, full);
      mbar_init(sm.v_full + st, full);
      mbar_init(sm.k_empty + st, 8);          // the consumers' eight warps
      mbar_init(sm.v_empty + st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {         // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(HB_PRODUCER_REGS));
    if ((!HB_TMA || threadIdx.x == 0) && n > 0)
      hb_produce<DH>(maps, a, sm, b, h, h / (a.H / a.KvH), q0, kt_begin, n);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(HB_CONSUMER_REGS));
  hb_consume<DH>(a, sm, b, h, q0, kt_begin, n);
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

// the TMA map of a contiguous (B, S, heads, dh) bf16 tensor whose boxes
// are 64 columns of `rows` rows of one head in the 128-byte swizzle;
// dimensions innermost first (column, head, row, batch), so the byte
// strides grow, and rows past S and columns past dh read as zeros
bool hb_encode(CUtensorMap* map, const void* base, int dh, int S, int heads,
               int B, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(dh) * 2,
                                 cuuint64_t(heads) * dh * 2,
                                 cuuint64_t(S) * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_hb(const FlashArgs& a, cudaStream_t s) {
  using T = HbTile<DH>;
  HbMaps maps;
  std::memset(&maps, 0, sizeof maps);
  if (!hb_encode(&maps.q, a.q, DH, a.Sq, a.H, a.B, HB_ROWS) ||
      !hb_encode(&maps.k, a.k, DH, a.Sk, a.KvH, a.B, T::BK) ||
      !hb_encode(&maps.v, a.v, DH, a.Sk, a.KvH, a.B, T::BK))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_hb<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(a.B * a.H, (a.Sq + HB_ROWS - 1) / HB_ROWS);
  flash_fwd_hb<DH><<<grid, HB_THREADS, T::SMEM, s>>>(maps, a);
  return int(cudaGetLastError());
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
      B > 65535 || H > 65535 || (dtype == 1 && Sq > 65535 * HB_ROWS))
    return int(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  const FlashArgs a{q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H,
                    KvH, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (Dh) {
      case 64: return launch_hb<64>(a, s);
      case 96: return launch_hb<96>(a, s);
      case 128: return launch_hb<128>(a, s);
      case 256: return launch_hb<256>(a, s);
    }
  }
  // float32 at every multiple of 64 (the wrapper pads Dh 96 to 128), bf16
  // past 256
  if (Dh > 0 && Dh % FW_CHUNK == 0 && (dtype == 0 || (dtype == 1 && Dh > 256)))
    return launch_fwd_wide(a, Dh, dtype == 1, s);
  return int(cudaErrorInvalidValue);
}

#endif
