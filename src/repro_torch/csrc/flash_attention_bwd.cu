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
// bfloat16, Dh <= 256 (flash_bwd_hb: launch 2 holds the dK / dV blocks and
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
// float32 at every width runs flash_bwd_hf (its paragraph below: every
// operand split into three bf16 parts on the tensor cores; TF32 would
// miss the float32 tolerance), Dh 96 zero-padded to 128 by the wrapper.
// The CUDA-core kernels it replaced at Dh <= 256 (64 x 64 tiles, three
// launches) took 1.5-2.9x SDPA's float32 backward (H100, PERF.md).
//
// Dh above 256 (the wrapper pads Dh to a multiple of 64, as the forward's
// wide path).  What bounds it: operations (at B 2, S 4096, H 16, Dh 512,
// causal, ~1.37 TFLOP of products against ~0.5 GB of traffic).  A 64-row
// bf16 tile at Dh 512 is 64 KB, so no block holds the four tiles a step
// reads (Q, dO, K, V), and 64 rows of dK and dV at Dh 512 are 256 KB of
// float32 sums, more than an SM's registers: each block owns an output
// column block of up to 256 columns.
//
// bfloat16 (flash_bwd_hw): a thread-block cluster of column blocks on the
// tensor cores.  The head's 64-column chunks are dealt into ncb =
// ceil(Dh / 256) column blocks of 2-4 chunks; the ncb blocks of a cluster
// share one kv tile (dK / dV blocks) or one query tile (dQ blocks), as in
// flash_bwd_hb, and block c stages only its own columns: Q_c, dO_c, K_c,
// V_c.  Per step, warpgroup 0 forms the partial S_c^T = K_c Q_c^T and
// warpgroup 1 dP_c^T = V_c dO_c^T (wgmma m64n64k16 chains, both operands
// K-major in the 128-byte swizzle); the blocks exchange the float32
// partials through distributed shared memory and every warpgroup of every
// block sums the ncb of them in rank order, so every block holds the same
// S and dP bit for bit; then P and dS (rounded once to bf16, dS from the
// unrounded P) and dV_c += P^T dO_c, dK_c += dS^T Q_c (dQ_c += dS K_c),
// register-A wgmma over the warpgroup's half of the block's columns.  So S
// and dP are formed once per cluster: seven tile products where the
// function needs five (the dQ blocks form S and dP again, which keeps
// every sum in one block: no atomics, a call repeats bit for bit).  This
// is the first of the two designs weighed; the second, column blocks that
// each form S and dP over the whole head from slices streamed through a
// ring, re-reads K and V from L2 every step and forms S and dP 2 ncb
// times (11 tile products at Dh 512).  Tiles are staged in bf16 by
// cp.async, Q_c / dO_c (K_c / V_c in a dQ block) in a ring of two stages.
// Shared memory: the fixed tiles 64 KB, two stages 128 KB, the exchange
// 32 KB, lse and delta 1 KB: 226 KB of the 227 a block may have, so one
// block an SM.  A cluster holds at most 8 blocks (the portable limit:
// Dh <= 2048); a wider head runs in more passes of the same kernel,
// without a cluster: one pass per column block adds its partials into
// float32 totals in global memory (the wrapper's scratch, zeroed), and a
// last pass reads the totals for its products.
//
// float32 (flash_bwd_hf, every width): flash_bwd_hw's cluster on the
// tensor cores, an instance a mode.  wgmma has no float32 operand, and TF32 keeps 10 bits
// (and takes K-major operands only, where dV += P^T dO and dK += dS^T Q
// read dO and Q MN-major), so every float32 operand v is split into three
// bf16 parts, v = hi + mid + lo, which hold every bit of it (each
// remainder is exact, as csrc/ssd_scan_bwd.cu splits), and a product runs
// as six bf16 part products, hi.hi, hi.mid, mid.hi, hi.lo, mid.mid and
// lo.hi: every one whose bits reach 2^-24 of the product (bf16 products
// are exact in float32).  Six products at 989 TFLOP/s are 165 TFLOP/s of
// float32-exact products, 2.5x the CUDA cores' 67; two TF32 parts would
// be 8 bytes an element against three bf16 parts' 6.  A chain runs the
// part products smallest first into float32 sums begun at zero each step
// and added to the running sums in float32, so the tensor cores'
// accumulation rounds only a step's part.  The parts triple the bf16
// tiles' bytes, so a column block is one 64-column chunk (ncb = Dh / 64,
// 8 a cluster at Dh 512): the fixed tiles 48 KB, two stages of the
// streamed ones 96 KB, the exchange 32 KB, float32 slots 32 KB, lse and
// delta 1 KB: 210 KB.  cp.async cannot convert: each thread copies its
// float32 slots a step ahead and splits them into the other stage while
// the step's partial product runs.  Warpgroup 0 forms S_c^T's partial,
// warpgroup 1 dP_c^T's (dK / dV blocks; S_c's and dP_c's in dQ blocks);
// the exchange's items are dealt to the cluster's ranks in equal runs,
// and each item's owner sums the ranks' partials in rank order, forms P
// and dS from them and writes them in their place in every block's
// exchange (two cluster barrier phases a step, no "read" phase: a block
// writes only its own exchange, and no other block touches it between
// the second barrier and the next first one).  Then warpgroup 0 adds dV_c
// += P^T dO_c and warpgroup 1 dK_c += dS^T Q_c; in a dQ block each adds
// dS K_c over half the tile's keys and the halves are summed once at the
// end.  P, dS and their products are float32-exact.  Past 8 blocks (Dh >
// 512) the passes through float32 totals, as bf16's past 8.  At the built
// widths a head is 1, 2 or 4 chunks.  Dh 64 runs each block alone
// (HW_ONE), where an exchange between blocks is pure cost: in a dK / dV
// block warpgroup 0 turns its S^T into P^T and hands it to warpgroup 1
// through the block's own exchange, which turns its dP^T into dS^T (a dQ
// block: P of half the keys one way, dP of the other half the other way),
// one block barrier a step and no cluster barrier or distributed shared
// memory.  Dh 128 and 256 keep the owners' exchange of 2 and 4 ranks.
// Sums in a fixed order, no atomics: a call repeats bit for bit.

#include <cstdint>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // the delta launch's, 8 warps
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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores, Dh <= 256
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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores, Dh above 256: a cluster of column blocks
// that exchange their partial S and dP (the header's design).  Taken over
// column blocks that each form S and dP over the whole head because it
// stages every tile once a step and forms S and dP once a cluster; what
// it pays instead is the exchange: reading the peers' partials and a
// cluster barrier a step, with one block an SM to hide them
// ---------------------------------------------------------------------------

constexpr int HW_CHUNK = 64;       // columns of a chunk, the swizzle's line
constexpr int HW_MAX_CHUNKS = 4;   // chunks a column block owns, at most
constexpr int HW_CLUSTER = 8;      // blocks of a cluster, at most (portable)
constexpr int HW_TB = HW_MAX_CHUNKS * HB_TILE * 128;   // bytes of a tile
// shared memory: six tiles (two fixed, two stages of two), the exchange
// (S and dP partials, 16 KB each), two stages of lse and delta, 1024 bytes
// to align
constexpr int HW_SMEM_BYTES = 7 * HW_TB + 2 * 2 * HB_TILE * 4 + 1024;
static_assert(HW_SMEM_BYTES <= SMEM_OPTIN_BYTES,
              "flash bwd hw: tiles exceed the shared memory of a block");

// how a launch finds S and dP: summed over the cluster's partials (one
// launch, Dh <= 2048); added into the global totals by one column block
// (dK / dV blocks alone, no products); read from the totals; float32
// alone (flash_bwd_hf), a head of one chunk: the block's own (HW_ONE, no
// cluster, its warpgroups share P or dP through the block's exchange)
enum HwMode { HW_EXCHANGE = 0, HW_ADD = 1, HW_READ = 2, HW_ONE = 3 };

struct HwArgs {
  int dh, nch, ncb;                // padded Dh, its chunks, column blocks
  int mode, cb;                    // HwMode; HW_ADD: the column block
  float* tot;                      // HW_ADD / HW_READ: (B, H, nq, nk) tiles
                                   // of [S, dP][query][key] float32
};

// the block's shared memory, 1024-aligned (the same offsets in every
// block of a cluster)
struct HwSmem {
  unsigned char* base;
  __device__ explicit HwSmem(void* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* fixed(int kind) const { return base + kind * HW_TB; }
  __device__ unsigned char* stage(int st, int kind) const {
    return base + (2 + 2 * st + kind) * HW_TB;
  }
  // [S, dP][n-tile j][thread wt] float4: a warpgroup's 64 x 64 partial in
  // accumulator order
  __device__ unsigned char* xch() const { return base + 6 * HW_TB; }
  __device__ float* rows(int st) const {
    return reinterpret_cast<float*>(base + 7 * HW_TB) + 2 * HB_TILE * st;
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the arrive after a step's partials are read: no release fence, since
// the loads are consumed before it (a fence a step cost 0.9 ms at Dh 512,
// H100, in turns: PERF.md)
__device__ __forceinline__ void cluster_arrive_read() {
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

// rows [r0, r0 + 64), chunks [ch0, ch0 + nc) of head `hd` of a (B, S,
// heads, dh) bf16 tensor into a swizzled tile by cp.async; rows >= S
// zeros.  Lane l of warp w copies 16-byte piece l of rows w + 8 i (a row
// of up to 4 chunks is 32 pieces; lanes past nc chunks idle)
__device__ __forceinline__ void stage_chunks(unsigned char* dst,
                                             const void* src, int b, int S,
                                             int heads, int hd, int r0,
                                             int dh, int ch0, int nc) {
  const int c = threadIdx.x % 32, w = threadIdx.x / 32;
  if (c >= nc * (HW_CHUNK / 8)) return;
  const size_t stride = size_t(heads) * dh;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(src)
      + (size_t(b) * S * heads + hd) * dh + HW_CHUNK * ch0 + 8 * c;
#pragma unroll
  for (int i = 0; i < HB_TILE / 8; ++i) {
    const int r = w + 8 * i, t = r0 + r;
    const bool in = t < S;
    cp_async16(dst + swz(r, c), base + (in ? t : 0) * stride, in ? 16 : 0);
  }
}

// acc = the warpgroup's partial a . b^T over the block's nc chunks (2-4):
// one wgmma chain, waited for
__device__ __forceinline__ void hw_partial(float acc[32], const unsigned char* a,
                                           const unsigned char* b, int nc) {
  if (nc == 2) wg_issue<128>(acc, a, b);
  else if (nc == 3) wg_issue<192>(acc, a, b);
  else wg_issue<256>(acc, a, b);
  wg_wait<64>(acc, nullptr);
}

// d (a thread's 64 floats) += a (the 64 x 64 bf16 fragments) . b over the
// warpgroup's nw chunks (1 or 2) from chunk j0 of the MN-major tile b;
// with e given, e += f . c alike; waited for
__device__ __forceinline__ void hw_accumulate(float* d, const uint32_t a[4][4],
                                              const unsigned char* b,
                                              float* e, const uint32_t f[4][4],
                                              const unsigned char* c, int j0,
                                              int nw) {
  if (nw == 2) {
    wg_accumulate<128>(d, a, b, 8 * j0);
    if (e != nullptr) wg_accumulate<128>(e, f, c, 8 * j0);
    wg_wait<128>(d, e);
  } else {
    wg_accumulate<64>(d, a, b, 8 * j0);
    if (e != nullptr) wg_accumulate<64>(e, f, c, 8 * j0);
    wg_wait<64>(d, e);
  }
}

// S and dP of n-tile j of this thread's accumulator (elements 4 j .. 4 j
// + 3) into s and d: HW_EXCHANGE sums the cluster's ncb partials in rank
// order; HW_READ loads the totals tile `tot` at [query][key] offsets
// `at(e)`
template <typename At>
__device__ __forceinline__ void hw_totals(float s[4], float d[4],
                                          const HwArgs& x, const float4* xch,
                                          const float* tot, int j, At at) {
  if (x.mode == HW_EXCHANGE) {
    const float4* sp = xch + j * 128 + threadIdx.x % 128;
    const float4* dp = sp + 8 * 128;
    float4 sv = *peer(sp, 0), dv = *peer(dp, 0);
    for (int c = 1; c < x.ncb; ++c) {
      const float4 s1 = *peer(sp, c), d1 = *peer(dp, c);
      sv.x += s1.x; sv.y += s1.y; sv.z += s1.z; sv.w += s1.w;
      dv.x += d1.x; dv.y += d1.y; dv.z += d1.z; dv.w += d1.w;
    }
    s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
    d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = tot[at(e)];
      d[e] = tot[HB_TILE * HB_TILE + at(e)];
    }
  }
}

// this warpgroup's partial (acc: S in warpgroup 0, dP in warpgroup 1) into
// the exchange, visible to the cluster; `first`: no step before it whose
// partials a block may still read
__device__ __forceinline__ void hw_publish(const float acc[32],
                                           unsigned char* xch, bool first) {
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  if (!first) cluster_wait();      // every block has read the last partials
  float4* out = reinterpret_cast<float4*>(xch + wg * 16384);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    out[j * 128 + wt] = make_float4(acc[4 * j], acc[4 * j + 1],
                                    acc[4 * j + 2], acc[4 * j + 3]);
  cluster_arrive();
  cluster_wait();
}

// the totals tile of (b, h, query tile qt, kv tile kt)
__device__ __forceinline__ float* hw_tile(const BwdArgs& a, const HwArgs& x,
                                          int b, int h, int qt, int kt) {
  const int nq = (a.Sq + HB_TILE - 1) / HB_TILE;
  const int nk = (a.Sk + HB_TILE - 1) / HB_TILE;
  return x.tot + (((size_t(b) * a.H + h) * nq + qt) * nk + kt)
                 * (2 * HB_TILE * HB_TILE);
}

// the column block's chunks: [ch0, ch0 + nc) of the head, this
// warpgroup's [j0, j0 + nw) of the block's (warpgroup 0 the first half)
struct HwCols {
  int ch0, nc, j0, nw;
  __device__ HwCols(const HwArgs& x, int cb) {
    ch0 = cb * x.nch / x.ncb;
    nc = (cb + 1) * x.nch / x.ncb - ch0;
    const int half = (nc + 1) / 2;
    j0 = threadIdx.x < 128 ? 0 : half;
    nw = threadIdx.x < 128 ? half : nc - half;
  }
};

// dK and dV of one (64-key tile, kv head, batch) over column block cb.
// Steps walk the group's G query heads and the query tiles that see a key
// of the tile, as hb_dkdv; warpgroup 0 forms S^T's partial, warpgroup 1
// dP^T's, both then P^T and dS^T from the totals and add bf16(P^T) dO_c and
// bf16(dS^T) Q_c into their half of the block's columns.
__device__ __forceinline__ void hw_dkdv(const BwdArgs& a, const HwArgs& x,
                                        const HwSmem& sm, int kt, int kvh,
                                        int b, int cb) {
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, w = wt / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int k0 = kt * HB_TILE, G = a.H / a.KvH;
  const HwCols col(x, cb);
  const bool products = x.mode != HW_ADD;
  int qt_begin, qt_end;
  query_tiles(a, k0, qt_begin, qt_end);
  const int per_head = qt_end - qt_begin, n_steps = G * per_head;
  auto load_step = [&](int i, int st) {
    const int h = kvh * G + i / per_head;
    const int q0 = (qt_begin + i % per_head) * HB_TILE;
    stage_chunks(sm.stage(st, 0), a.q, b, a.Sq, a.H, h, q0, x.dh, col.ch0,
                 col.nc);
    stage_chunks(sm.stage(st, 1), a.dout, b, a.Sq, a.H, h, q0, x.dh, col.ch0,
                 col.nc);
    if (products) stage_rows(sm.rows(st), a, b, h, q0);
  };
  if (x.mode != HW_READ) {
    stage_chunks(sm.fixed(0), a.k, b, a.Sk, a.KvH, kvh, k0, x.dh, col.ch0,
                 col.nc);
    stage_chunks(sm.fixed(1), a.v, b, a.Sk, a.KvH, kvh, k0, x.dh, col.ch0,
                 col.nc);
  }
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const int key0 = 16 * w + g;     // this thread's keys in the tile: + 8
  const float4* xch = reinterpret_cast<const float4*>(sm.xch());

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1, h = kvh * G + i / per_head;
    const int qt = qt_begin + i % per_head, q0 = qt * HB_TILE;
    cp_async_wait_all();             // step i's tiles have landed
    fence_proxy_async();
    __syncthreads();                 // ... for every thread; step i - 1 done
    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);
    cp_async_commit();
    const unsigned char* qs = sm.stage(st, 0);
    const unsigned char* dos = sm.stage(st, 1);
    float acc[32];
    if (x.mode != HW_READ) hw_partial(acc, sm.fixed(wg), sm.stage(st, wg),
                                      col.nc);
    float* tot = x.mode == HW_EXCHANGE ? nullptr : hw_tile(a, x, b, h, qt, kt);
    // [query][key] offset of element e of n-tile j (S^T: keys are rows)
    auto at = [&](int j, int e) {
      return (8 * j + 2 * t4 + (e & 1)) * HB_TILE + key0 + 8 * (e >> 1);
    };
    if (x.mode == HW_ADD) {          // totals += this block's partial
      float* t = tot + wg * HB_TILE * HB_TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[at(j, e)] += acc[4 * j + e];
      continue;
    }
    if (x.mode == HW_EXCHANGE) hw_publish(acc, sm.xch(), i == 0);
    const float* lse_s = sm.rows(st);
    const float* del_s = lse_s + HB_TILE;
    const bool full = all_seen(a, q0, k0);
    uint32_t pa[4][4], sa[4][4];     // bf16 P^T and dS^T, k-steps of 16
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s[4], d[4];
      hw_totals(s, d, x, xch, tot, j, [&](int e) { return at(j, e); });
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t4 + (e & 1);
        const bool ok = full || seen(a, q0 + qc, k0 + key0 + 8 * (e >> 1));
        const float p = ok
            ? hb_exp2((s[e] * a.scale - lse_s[qc]) * LOG2E) : 0.f;
        s[e] = p;
        d[e] = p * (d[e] - del_s[qc]);
      }
      pa[j >> 1][2 * (j & 1)] = pack_bf16(s[0], s[1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(s[2], s[3]);
      sa[j >> 1][2 * (j & 1)] = pack_bf16(d[0], d[1]);
      sa[j >> 1][2 * (j & 1) + 1] = pack_bf16(d[2], d[3]);
    }
    if (x.mode == HW_EXCHANGE) cluster_arrive_read();
    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q over this warpgroup's chunks
    hw_accumulate(dv, pa, dos, dk, sa, qs, col.j0, col.nw);
  }
  if (x.mode == HW_EXCHANGE && n_steps > 0) cluster_wait();
  cp_async_wait_all();             // nothing in flight at exit
  if (!products) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + key0 + 8 * r;
    if (key >= a.Sk) continue;
    const size_t at = ((size_t(b) * a.Sk + key) * a.KvH + kvh) * x.dh
                      + HW_CHUNK * (col.ch0 + col.j0);
    __nv_bfloat16* dkr = static_cast<__nv_bfloat16*>(a.dk) + at;
    __nv_bfloat16* dvr = static_cast<__nv_bfloat16*>(a.dv) + at;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j >= 8 * col.nw) break;
      *reinterpret_cast<uint32_t*>(dkr + 8 * j + 2 * t4) =
          pack_bf16(dk[4 * j + 2 * r] * a.scale,
                    dk[4 * j + 2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * j + 2 * t4) =
          pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// dQ of one (64-row query tile, head, batch) over column block cb: steps
// walk the kv tiles the rows see, as hb_dq; warpgroup 0 forms S's partial,
// warpgroup 1 dP's, both then dS from the totals and add bf16(dS) K_c into
// their half of the block's columns.
__device__ __forceinline__ void hw_dq(const BwdArgs& a, const HwArgs& x,
                                      const HwSmem& sm, int qt, int h, int b,
                                      int cb) {
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, w = wt / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int q0 = qt * HB_TILE, kvh = h / (a.H / a.KvH);
  const HwCols col(x, cb);
  int kt_begin, kt_end;
  kv_tiles(a, q0, kt_begin, kt_end);
  auto load_step = [&](int kt, int st) {
    stage_chunks(sm.stage(st, 0), a.k, b, a.Sk, a.KvH, kvh, kt * HB_TILE,
                 x.dh, col.ch0, col.nc);
    if (x.mode != HW_READ)
      stage_chunks(sm.stage(st, 1), a.v, b, a.Sk, a.KvH, kvh, kt * HB_TILE,
                   x.dh, col.ch0, col.nc);
  };
  if (x.mode != HW_READ) {
    stage_chunks(sm.fixed(0), a.q, b, a.Sq, a.H, h, q0, x.dh, col.ch0,
                 col.nc);
    stage_chunks(sm.fixed(1), a.dout, b, a.Sq, a.H, h, q0, x.dh, col.ch0,
                 col.nc);
  }
  if (kt_begin < kt_end) load_step(kt_begin, 0);
  cp_async_commit();

  // this thread's rows in the tile, row0 and row0 + 8: their lse and delta
  const int row0 = 16 * w + g;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    const size_t at = (size_t(b) * a.H + h) * a.Sq + qi;
    lse_r[r] = qi < a.Sq ? a.lse[at] : 0.f;
    del_r[r] = qi < a.Sq ? a.delta[at] : 0.f;
  }
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  const float4* xch = reinterpret_cast<const float4*>(sm.xch());

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1, k0 = kt * HB_TILE;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < kt_end) load_step(kt + 1, st ^ 1);
    cp_async_commit();
    const unsigned char* ks = sm.stage(st, 0);
    float acc[32];
    const float* tot = nullptr;
    if (x.mode == HW_EXCHANGE) {
      hw_partial(acc, sm.fixed(wg), sm.stage(st, wg), col.nc);
      hw_publish(acc, sm.xch(), kt == kt_begin);
    } else {
      tot = hw_tile(a, x, b, h, qt, kt);
    }
    const bool full = all_seen(a, q0, k0);
    uint32_t sa[4][4];               // bf16 dS, k-steps of 16 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s[4], d[4];
      hw_totals(s, d, x, xch, tot, j, [&](int e) {
        return (row0 + 8 * (e >> 1)) * HB_TILE + 8 * j + 2 * t4 + (e & 1);
      });
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = full || seen(a, q0 + row0 + 8 * (e >> 1),
                                     k0 + 8 * j + 2 * t4 + (e & 1));
        const float p = ok
            ? hb_exp2((s[e] * a.scale - lse_r[e >> 1]) * LOG2E) : 0.f;
        d[e] = p * (d[e] - del_r[e >> 1]);
      }
      sa[j >> 1][2 * (j & 1)] = pack_bf16(d[0], d[1]);
      sa[j >> 1][2 * (j & 1) + 1] = pack_bf16(d[2], d[3]);
    }
    if (x.mode == HW_EXCHANGE) cluster_arrive_read();
    // dQ += bf16(dS) K over this warpgroup's chunks
    hw_accumulate(dq, sa, ks, nullptr, sa, ks, col.j0, col.nw);
  }
  if (x.mode == HW_EXCHANGE && kt_begin < kt_end) cluster_wait();
  cp_async_wait_all();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= a.Sq) continue;
    __nv_bfloat16* row = static_cast<__nv_bfloat16*>(a.dq)
        + ((size_t(b) * a.Sq + qi) * a.H + h) * x.dh
        + HW_CHUNK * (col.ch0 + col.j0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j >= 8 * col.nw) break;
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(dq[4 * j + 2 * r] * a.scale,
                    dq[4 * j + 2 * r + 1] * a.scale);
    }
  }
}

// the dK / dV items (kv tile slowest), then the dQ items (last query tile
// first), as flash_bwd_hb; HW_EXCHANGE and HW_READ launch ncb blocks an
// item (a cluster of them in HW_EXCHANGE), HW_ADD one, dK / dV items only
__global__ void __launch_bounds__(256, 1) flash_bwd_hw(BwdArgs a, HwArgs x) {
  extern __shared__ float4 smem4[];
  const HwSmem sm(smem4);
  const int per = x.mode == HW_ADD ? 1 : x.ncb;
  const int id = blockIdx.x / per;
  const int cb = x.mode == HW_ADD ? x.cb : int(blockIdx.x % per);
  const int n_kv = (a.Sk + HB_TILE - 1) / HB_TILE * a.KvH * a.B;
  if (id < n_kv) {
    const int kt = id / (a.KvH * a.B), rest = id % (a.KvH * a.B);
    hw_dkdv(a, x, sm, kt, rest % a.KvH, rest / a.KvH, cb);
  } else {
    const int j = id - n_kv, nq = (a.Sq + HB_TILE - 1) / HB_TILE;
    const int qt = nq - 1 - j / (a.H * a.B), rest = j % (a.H * a.B);
    hw_dq(a, x, sm, qt, rest % a.H, rest / a.H, cb);
  }
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores, Dh above 256: flash_bwd_hw's cluster of
// column blocks with every operand split into three bf16 parts (the
// header's design).  A block owns one 64-column chunk; the owners of the
// exchange's items sum the cluster's partials and form P and dS from them
// ---------------------------------------------------------------------------

constexpr int HF_PARTS = 3;        // bf16 parts of a float32 operand
// part products of a . b, pair p = (a part hf_pa(p), b part hf_pb(p)):
// hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi, every one whose bits
// reach 2^-24 of the product; chains run them from the last, smallest
// first
constexpr int HF_PAIRS = 6;
__device__ __forceinline__ int hf_pa(int p) {
  return p == 2 || p == 4 ? 1 : p == 5 ? 2 : 0;
}
__device__ __forceinline__ int hf_pb(int p) {
  return p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0;
}
constexpr int HF_PT = HB_TILE * 128;       // one part of a chunk tile, 8 KB
constexpr int HF_TB = HF_PARTS * HF_PT;    // a chunk tile in parts, 24 KB
constexpr int HF_ITEMS = HB_TILE * HB_TILE / 4;   // float4s of a partial
// shared memory: six tiles (two fixed, two stages of two), the exchange
// (S and dP partials, 16 KB each), the float32 slots of two chunk tiles
// (32 KB), two stages of lse and delta, 1024 bytes to align: 210 KB
constexpr int HF_SMEM_BYTES = 6 * HF_TB + 2 * 2 * HF_ITEMS * 16
                            + 2 * 2 * HB_TILE * 4 + 1024;
static_assert(HF_SMEM_BYTES <= SMEM_OPTIN_BYTES,
              "flash bwd hf: tiles exceed the shared memory of a block");

struct HfSmem {
  unsigned char* base;
  __device__ explicit HfSmem(void* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}
  __device__ unsigned char* fixed(int kind) const { return base + kind * HF_TB; }
  __device__ unsigned char* stage(int st, int kind) const {
    return base + (2 + 2 * st + kind) * HF_TB;
  }
  // [S | dP][n-tile j][thread wt] float4: the warpgroups' 64 x 64
  // partials in accumulator order, then in the owners' items P and dS
  __device__ float4* xch() const {
    return reinterpret_cast<float4*>(base + 6 * HF_TB);
  }
  // the float32 slots of two chunk tiles (kind 0, kind 1), for hf_copy
  __device__ float4* slots(int kind) const {
    return xch() + (2 + kind) * HF_ITEMS;
  }
  __device__ float* rows(int st) const {
    return reinterpret_cast<float*>(base + 6 * HF_TB + 4 * HF_ITEMS * 16)
           + 2 * HB_TILE * st;
  }
};

// (u, v) = hi + mid + lo, bf16 pairs that hold every bit of both (each
// remainder is exact), as csrc/ssd_scan_bwd.cu splits: w[q] packs part q
__device__ __forceinline__ void split3(float u, float v, uint32_t w[HF_PARTS]) {
#pragma unroll
  for (int q = 0; q < HF_PARTS; ++q) {
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
// its own slots (hf_split), so the slots need no barrier
template <int ROWS>
__device__ __forceinline__ void hf_copy(float4* f, const void* src, int b,
                                        int S, int heads, int hd, int r0,
                                        int dh, int ch) {
  const float* base = static_cast<const float*>(src)
      + (size_t(b) * S * heads + hd) * dh + 64 * ch;
#pragma unroll
  for (int i = 0; i < ROWS / 16; ++i) {
    const int idx = threadIdx.x + 256 * i, t = r0 + idx / 16;
    const bool in = t < S;
    cp_async16(f + idx, base + size_t(in ? t : 0) * heads * dh
                            + 4 * (idx % 16), in ? 16 : 0);
  }
}
// this thread's slots of `f` (landed) split into the three parts of a
// swizzled chunk tile of ROWS rows (part q at dst + q ROWS 128)
template <int ROWS>
__device__ __forceinline__ void hf_split(unsigned char* dst, const float4* f) {
#pragma unroll
  for (int i = 0; i < ROWS / 16; ++i) {
    const int idx = threadIdx.x + 256 * i, r = idx / 16, c4 = idx % 16;
    const float4 v = f[idx];
    uint32_t lo[HF_PARTS], hi[HF_PARTS];
    split3(v.x, v.y, lo);
    split3(v.z, v.w, hi);
    unsigned char* d = dst + r * 128 + (((c4 >> 1) ^ (r & 7)) << 4)
                     + 8 * (c4 & 1);
#pragma unroll
    for (int q = 0; q < HF_PARTS; ++q)
      *reinterpret_cast<uint2*>(d + q * ROWS * 128) = make_uint2(lo[q], hi[q]);
  }
  asm volatile("" ::: "memory");   // the slots are read before new copies
}

// acc = a . b^T over one chunk for the warpgroup: a (its 64 M rows) and b
// (64 N rows) K-major chunk tiles in three parts, `pa` and `pb` bytes
// apart; the part products smallest first, one wgmma chain, committed
// (wait for it with wg_wait)
// (the pairs a runtime loop, each descriptor its tile's plus an offset in
// 16-byte units, so that the chain's descriptors are not all hoisted into
// registers)
__device__ __forceinline__ void hf_issue(float acc[32], const unsigned char* a,
                                         int pa, const unsigned char* b,
                                         int pb) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
  for (int p = HF_PAIRS - 1; p >= 0; --p) {
    const uint64_t ap = da + hf_pa(p) * (pa >> 4), bp = db + hf_pb(p) * (pb >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_64x64(acc, ap + 2 * kk, bp + 2 * kk, p < HF_PAIRS - 1 || kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// d (the warpgroup's 64 x 64, from zero) = f (A fragments of NK k-steps, in
// three parts) . b (an MN-major chunk tile in three parts, k-step kk at
// rows 16 (k0 + kk)): the part products smallest first, one register-A
// chain, committed (wait with wg_wait)
template <int NK>
__device__ __forceinline__ void hf_rs(float d[32],
                                      const uint32_t f[HF_PARTS][NK][4],
                                      const unsigned char* b, int k0) {
  const uint64_t db = mn_desc(b + k0 * 16 * 128);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int p = HF_PAIRS - 1; p >= 0; --p)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_rs<64>(d, f[hf_pa(p)][kk],
                   db + ((hf_pb(p) * HF_PT + kk * 16 * 128) >> 4));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// A fragments of NK k-steps from 8 NK accumulator floats v (n-tiles 2 kk
// and 2 kk + 1 make k-step kk), split into parts
template <int NK>
__device__ __forceinline__ void hf_frags(uint32_t f[HF_PARTS][NK][4],
                                         const float* v) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t w[HF_PARTS];
      split3(v[8 * kk + 2 * r], v[8 * kk + 2 * r + 1], w);
#pragma unroll
      for (int q = 0; q < HF_PARTS; ++q) f[q][kk][r] = w[q];
    }
}

// P and dS of exchange item `pos` (n-tile j = pos / 128 of thread wt = pos
// % 128: element e at row 16 (wt / 32) + (wt % 32) / 4 + 8 (e / 2), column
// 8 j + 2 (wt % 4) + e % 2) from its totals s (S; S^T in a dK / dV block,
// `kv`, whose rows are keys) and d (dP), masked entries 0; `rows` holds
// the query tile's lse, then its delta
// the query row (in the tile) of element e of item pos
__device__ __forceinline__ int hf_qrow(bool kv, int pos, int e) {
  const int wt = pos % 128, lane = wt % 32;
  return kv ? 8 * (pos / 128) + 2 * (lane % 4) + (e & 1)
            : 16 * (wt / 32) + lane / 4 + 8 * (e >> 1);
}
// P of item pos from its S total s (masked entries 0): exp(s scale - lse)
__device__ __forceinline__ float4 hf_p(float4 s, const BwdArgs& a, bool kv,
                                       int q0, int k0, bool full,
                                       const float* rows, int pos) {
  const int wt = pos % 128, lane = wt % 32;
  const int row0 = 16 * (wt / 32) + lane / 4, col0 = 8 * (pos / 128)
                                                    + 2 * (lane % 4);
  float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qr = hf_qrow(kv, pos, e);
    const int kr = kv ? row0 + 8 * (e >> 1) : col0 + (e & 1);
    const bool ok = full || seen(a, q0 + qr, k0 + kr);
    sv[e] = ok ? expf(sv[e] * a.scale - rows[qr]) : 0.f;
  }
  return make_float4(sv[0], sv[1], sv[2], sv[3]);
}
// dS = P o (dP - delta) of item pos
__device__ __forceinline__ float4 hf_ds(float4 p, float4 d, bool kv,
                                        const float* rows, int pos) {
  const float* del = rows + HB_TILE;
  return make_float4(p.x * (d.x - del[hf_qrow(kv, pos, 0)]),
                     p.y * (d.y - del[hf_qrow(kv, pos, 1)]),
                     p.z * (d.z - del[hf_qrow(kv, pos, 2)]),
                     p.w * (d.w - del[hf_qrow(kv, pos, 3)]));
}
__device__ __forceinline__ void hf_pds(float4& s, float4& d, const BwdArgs& a,
                                       bool kv, int q0, int k0, bool full,
                                       const float* rows, int pos) {
  s = hf_p(s, a, kv, q0, k0, full, rows, pos);
  d = hf_ds(s, d, kv, rows, pos);
}
__device__ __forceinline__ float4 acc4(const float* acc, int j) {
  return make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                     acc[4 * j + 3]);
}
__device__ __forceinline__ void put4(float* v, float4 t) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// HW_ONE, a dK / dV block: warpgroup 0 turns its S^T into P^T and puts it
// in the block's exchange, warpgroup 1 reads it there and turns its dP^T
// into dS^T; v gets P^T (warpgroup 0) or dS^T (1).  One block barrier (the
// exchange is free again at the next step's first barrier)
__device__ __forceinline__ void hf_one_kv(float v[32], const float acc[32],
                                          float4* xch, const BwdArgs& a,
                                          int q0, int k0, bool full,
                                          const float* rows) {
  const int wt = threadIdx.x % 128;
  if (threadIdx.x < 128) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 p = hf_p(acc4(acc, j), a, true, q0, k0, full, rows,
                            j * 128 + wt);
      xch[j * 128 + wt] = p;
      put4(v + 4 * j, p);
    }
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      put4(v + 4 * j, hf_ds(xch[j * 128 + wt], acc4(acc, j), true, rows,
                            j * 128 + wt));
  }
}
// HW_ONE, a dQ block: warpgroup 0 (S) hands P of n-tiles 4-7 to warpgroup
// 1 through its half of the block's exchange and keeps 0-3; warpgroup 1
// (dP) hands dP of n-tiles 0-3 over through its half and keeps 4-7; after
// one block barrier each forms dS of its own half, n-tiles 4 wg .. 4 wg +
// 3, into v
__device__ __forceinline__ void hf_one_q(float v[16], const float acc[32],
                                         float4* xch, const BwdArgs& a,
                                         int q0, int k0, bool full,
                                         const float* rows) {
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  float4* out = xch + wg * HF_ITEMS;
  const float4* in = xch + (1 - wg) * HF_ITEMS;
  float4 mine[4];
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 p = hf_p(acc4(acc, j), a, false, q0, k0, full, rows,
                            j * 128 + wt);
      if (j < 4) mine[j] = p;
      else out[j * 128 + wt] = p;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j * 128 + wt] = acc4(acc, j);
      mine[j] = acc4(acc, 4 + j);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int pos = (4 * wg + j) * 128 + wt;
    const float4 other = in[pos];
    put4(v + 4 * j, wg == 0 ? hf_ds(mine[j], other, false, rows, pos)
                            : hf_ds(other, mine[j], false, rows, pos));
  }
}

// this warpgroup's partial (S in warpgroup 0, dP in 1) into the exchange
// (every block's reads of the last step's items ended at its last
// barrier); then a cluster barrier: the partials are published
__device__ __forceinline__ void hf_publish(const float acc[32], float4* xch) {
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    xch[wg * HF_ITEMS + j * 128 + wt] =
        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  cluster_arrive();
  cluster_wait();
}
// the run of items block `me` owns: S and dP summed over the cluster's
// `ranks` partials in rank order, P and dS from them written in their
// place in every block's exchange (no other block reads or writes these
// items until the barrier that ends this); then that barrier, after which
// each block reads its P and dS from its own exchange
__device__ __forceinline__ void hf_reduce(const BwdArgs& a, int ranks, int me,
                                          float4* xch, bool kv, int q0,
                                          int k0, bool full,
                                          const float* rows) {
  const int end = ((me + 1) * HF_ITEMS + ranks - 1) / ranks;
  for (int pos = (me * HF_ITEMS + ranks - 1) / ranks + threadIdx.x;
       pos < end; pos += 256) {
    float4 s[HW_CLUSTER], d[HW_CLUSTER];
#pragma unroll
    for (int r = 0; r < HW_CLUSTER; ++r)
      if (r < ranks) {
        const float4* src = r == me ? xch : peer(xch, r);
        s[r] = src[pos];
        d[r] = src[HF_ITEMS + pos];
      }
#pragma unroll
    for (int r = 1; r < HW_CLUSTER; ++r)
      if (r < ranks) {
        s[0].x += s[r].x; s[0].y += s[r].y; s[0].z += s[r].z;
        s[0].w += s[r].w;
        d[0].x += d[r].x; d[0].y += d[r].y; d[0].z += d[r].z;
        d[0].w += d[r].w;
      }
    hf_pds(s[0], d[0], a, kv, q0, k0, full, rows, pos);
#pragma unroll
    for (int r = 0; r < HW_CLUSTER; ++r)
      if (r < ranks) {
        float4* dst = r == me ? xch : const_cast<float4*>(peer(xch, r));
        dst[pos] = s[0];
        dst[HF_ITEMS + pos] = d[0];
      }
  }
  cluster_arrive();
  cluster_wait();
}
// this thread's items of n-tiles [j0, j0 + NJ) of one half of the
// exchange (0: P, 1: dS), into v
template <int NJ>
__device__ __forceinline__ void hf_gather(float* v, const float4* xch,
                                          int half, int j0) {
  const int wt = threadIdx.x % 128;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float4 t = xch[half * HF_ITEMS + (j0 + j) * 128 + wt];
    v[4 * j] = t.x; v[4 * j + 1] = t.y; v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
}
// HW_READ: this thread's P (half 0) or dS (1) of n-tiles [j0, j0 + NJ)
// from the global totals `tot` ([S, dP][query][key]), its element e of
// n-tile j at offset at(j, e)
template <int NJ, typename At>
__device__ __forceinline__ void hf_read(float* v, const BwdArgs& a,
                                        const float* tot, int half, int j0,
                                        bool kv, int q0, int k0, bool full,
                                        const float* rows, At at) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float e4[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      e4[0][e] = tot[at(j0 + j, e)];
      e4[1][e] = tot[HB_TILE * HB_TILE + at(j0 + j, e)];
    }
    float4 s = make_float4(e4[0][0], e4[0][1], e4[0][2], e4[0][3]);
    float4 d = make_float4(e4[1][0], e4[1][1], e4[1][2], e4[1][3]);
    hf_pds(s, d, a, kv, q0, k0, full, rows, (j0 + j) * 128 + threadIdx.x % 128);
    const float4 t = half ? d : s;
    v[4 * j] = t.x; v[4 * j + 1] = t.y; v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
}

// dV (warpgroup 0) and dK (1) of one (64-key tile, kv head, batch) over
// column chunk cb.  Steps walk the group's G query heads and the query
// tiles that see a key of the tile, as hw_dkdv; warpgroup 0 forms S^T's
// partial K_c Q_c^T, warpgroup 1 dP^T's V_c dO_c^T; from the owners' P^T
// and dS^T, dV_c += P^T dO_c (0) and dK_c += dS^T Q_c (1), each step's
// product summed from zero and added in float32.  The next step's Q_c and
// dO_c are loaded into registers a step ahead and split into the other
// stage while this step's products run.
template <int MODE>
__device__ __forceinline__ void hf_dkdv(const BwdArgs& a, const HwArgs& x,
                                        const HfSmem& sm, int kt, int kvh,
                                        int b, int cb) {
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, w = wt / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int k0 = kt * HB_TILE, G = a.H / a.KvH;
  int qt_begin, qt_end;
  query_tiles(a, k0, qt_begin, qt_end);
  const int per_head = qt_end - qt_begin, n_steps = G * per_head;
  auto head = [&](int i) { return kvh * G + i / per_head; };
  auto tile = [&](int i) { return qt_begin + i % per_head; };
  auto copy = [&](int i) {         // step i's Q_c and dO_c into the slots
    hf_copy<HB_TILE>(sm.slots(0), a.q, b, a.Sq, a.H, head(i),
                     tile(i) * HB_TILE, x.dh, cb);
    hf_copy<HB_TILE>(sm.slots(1), a.dout, b, a.Sq, a.H, head(i),
                     tile(i) * HB_TILE, x.dh, cb);
  };
  auto split = [&](unsigned char* t0, unsigned char* t1) {
    hf_split<HB_TILE>(t0, sm.slots(0));
    hf_split<HB_TILE>(t1, sm.slots(1));
  };
  hf_copy<HB_TILE>(sm.slots(0), a.k, b, a.Sk, a.KvH, kvh, k0, x.dh, cb);
  hf_copy<HB_TILE>(sm.slots(1), a.v, b, a.Sk, a.KvH, kvh, k0, x.dh, cb);
  cp_async_commit();
  cp_async_wait_all();
  split(sm.fixed(0), sm.fixed(1));
  if (n_steps > 0) {
    copy(0);
    cp_async_commit();
    cp_async_wait_all();
    split(sm.stage(0, 0), sm.stage(0, 1));
    stage_rows(sm.rows(0), a, b, head(0), tile(0) * HB_TILE);
  }
  if (n_steps > 1) copy(1);
  cp_async_commit();

  float out[32];                   // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] = 0.f;
  // [query][key] offset of element e of n-tile j (S^T: keys are rows)
  auto at = [&](int j, int e) {
    return (8 * j + 2 * t4 + (e & 1)) * HB_TILE + 16 * w + g + 8 * (e >> 1);
  };

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1, h = head(i), qt = tile(i), q0 = qt * HB_TILE;
    cp_async_wait_all();             // step i's rows, i + 1's slots landed
    fence_proxy_async();             // step i's split tiles are visible to
    __syncthreads();                 // wgmma, for every thread; i - 1 done
    if (i + 1 < n_steps)
      stage_rows(sm.rows(st ^ 1), a, b, head(i + 1), tile(i + 1) * HB_TILE);
    cp_async_commit();
    const bool full = all_seen(a, q0, k0);
    float acc[32], tmp[32];
    if constexpr (MODE != HW_READ)
      hf_issue(acc, sm.fixed(wg), HF_PT, sm.stage(st, wg), HF_PT);
    // while the partial runs: step i + 1's tiles split, i + 2's copied
    if (i + 1 < n_steps) split(sm.stage(st ^ 1, 0), sm.stage(st ^ 1, 1));
    if (i + 2 < n_steps) copy(i + 2);
    cp_async_commit();
    if constexpr (MODE != HW_READ) wg_wait<64>(acc, nullptr);
    float* tot = MODE == HW_ADD || MODE == HW_READ
        ? hw_tile(a, x, b, h, qt, kt) : nullptr;
    if constexpr (MODE == HW_ADD) {  // totals += this block's partial
      float* t = tot + wg * HB_TILE * HB_TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[at(j, e)] += acc[4 * j + e];
    } else {
      float v[32];                   // P^T (warpgroup 0) or dS^T (1)
      if constexpr (MODE == HW_EXCHANGE) {
        hf_publish(acc, sm.xch());
        hf_reduce(a, x.ncb, cb, sm.xch(), true, q0, k0, full, sm.rows(st));
        hf_gather<8>(v, sm.xch(), wg, 0);
      } else if constexpr (MODE == HW_ONE) {
        hf_one_kv(v, acc, sm.xch(), a, q0, k0, full, sm.rows(st));
      } else {
        hf_read<8>(v, a, tot, wg, 0, true, q0, k0, full, sm.rows(st), at);
      }
      uint32_t f[HF_PARTS][4][4];
      hf_frags<4>(f, v);
      hf_rs<4>(tmp, f, sm.stage(st, 1 - wg), 0);
      wg_wait<64>(tmp, nullptr);
#pragma unroll
      for (int e = 0; e < 32; ++e) out[e] += tmp[e];
    }
  }
  cp_async_wait_all();             // nothing in flight at exit
  if constexpr (MODE == HW_ADD) return;
  const float mult = wg ? a.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * w + g + 8 * r;
    if (key >= a.Sk) continue;
    float* row = static_cast<float*>(wg ? a.dk : a.dv)
        + ((size_t(b) * a.Sk + key) * a.KvH + kvh) * x.dh + HW_CHUNK * cb;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
          make_float2(out[4 * j + 2 * r] * mult, out[4 * j + 2 * r + 1] * mult);
  }
}

// dQ of one (64-row query tile, head, batch) over column chunk cb: steps
// walk the kv tiles the rows see, as hw_dq; warpgroup 0 forms S's partial
// Q_c K_c^T, warpgroup 1 dP's dO_c V_c^T; from the owners' dS, each
// warpgroup adds dS K_c over its half of the tile's keys (32 w .. + 31)
// into its own float32 sums, and the two halves are added once at the end.
template <int MODE>
__device__ __forceinline__ void hf_dq(const BwdArgs& a, const HwArgs& x,
                                      const HfSmem& sm, int qt, int h, int b,
                                      int cb) {
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128, w = wt / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int q0 = qt * HB_TILE, kvh = h / (a.H / a.KvH);
  int kt_begin, kt_end;
  kv_tiles(a, q0, kt_begin, kt_end);
  const int n = kt_end - kt_begin;
  auto copy = [&](int i) {         // step i's K_c and V_c into the slots
    const int k0 = (kt_begin + i) * HB_TILE;
    hf_copy<HB_TILE>(sm.slots(0), a.k, b, a.Sk, a.KvH, kvh, k0, x.dh, cb);
    hf_copy<HB_TILE>(sm.slots(1), a.v, b, a.Sk, a.KvH, kvh, k0, x.dh, cb);
  };
  auto split = [&](unsigned char* t0, unsigned char* t1) {
    hf_split<HB_TILE>(t0, sm.slots(0));
    hf_split<HB_TILE>(t1, sm.slots(1));
  };
  hf_copy<HB_TILE>(sm.slots(0), a.q, b, a.Sq, a.H, h, q0, x.dh, cb);
  hf_copy<HB_TILE>(sm.slots(1), a.dout, b, a.Sq, a.H, h, q0, x.dh, cb);
  stage_rows(sm.rows(0), a, b, h, q0);
  cp_async_commit();
  cp_async_wait_all();
  split(sm.fixed(0), sm.fixed(1));
  if (n > 0) {
    copy(0);
    cp_async_commit();
    cp_async_wait_all();
    split(sm.stage(0, 0), sm.stage(0, 1));
  }
  if (n > 1) copy(1);
  cp_async_commit();

  float out[32];                   // dQ_c over this warpgroup's keys
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] = 0.f;
  const int row0 = 16 * w + g;     // this thread's rows: + 8
  const float* rows = sm.rows(0);

  for (int i = 0; i < n; ++i) {
    const int st = i & 1, kt = kt_begin + i, k0 = kt * HB_TILE;
    cp_async_wait_all();             // step i + 1's slots have landed
    fence_proxy_async();
    __syncthreads();
    const bool full = all_seen(a, q0, k0);
    float v[16], tmp[32];            // dS of this warpgroup's keys
    float acc[32];
    if constexpr (MODE != HW_READ)
      hf_issue(acc, sm.fixed(wg), HF_PT, sm.stage(st, wg), HF_PT);
    // while the partial runs: step i + 1's tiles split, i + 2's copied
    if (i + 1 < n) split(sm.stage(st ^ 1, 0), sm.stage(st ^ 1, 1));
    if (i + 2 < n) copy(i + 2);
    cp_async_commit();
    if constexpr (MODE == HW_EXCHANGE) {
      wg_wait<64>(acc, nullptr);
      hf_publish(acc, sm.xch());
      hf_reduce(a, x.ncb, cb, sm.xch(), false, q0, k0, full, rows);
      hf_gather<4>(v, sm.xch(), 1, 4 * wg);
    } else if constexpr (MODE == HW_ONE) {
      wg_wait<64>(acc, nullptr);
      hf_one_q(v, acc, sm.xch(), a, q0, k0, full, rows);
    } else {
      hf_read<4>(v, a, hw_tile(a, x, b, h, qt, kt), 1, 4 * wg, false, q0, k0,
                 full, rows, [&](int j, int e) {
                   return (row0 + 8 * (e >> 1)) * HB_TILE + 8 * j + 2 * t4
                          + (e & 1);
                 });
    }
    uint32_t f[HF_PARTS][2][4];
    hf_frags<2>(f, v);
    hf_rs<2>(tmp, f, sm.stage(st, 0), 2 * wg);
    wg_wait<64>(tmp, nullptr);
#pragma unroll
    for (int e = 0; e < 32; ++e) out[e] += tmp[e];
  }
  cp_async_wait_all();
  // dQ_c = warpgroup 0's sums + warpgroup 1's, through the fixed Q tile
  float4* half = reinterpret_cast<float4*>(sm.fixed(0));
  if (wg == 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      half[j * 128 + wt] = make_float4(out[4 * j], out[4 * j + 1],
                                       out[4 * j + 2], out[4 * j + 3]);
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 t = half[j * 128 + wt];
    out[4 * j] += t.x; out[4 * j + 1] += t.y; out[4 * j + 2] += t.z;
    out[4 * j + 3] += t.w;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= a.Sq) continue;
    float* row = static_cast<float*>(a.dq)
        + ((size_t(b) * a.Sq + qi) * a.H + h) * x.dh + HW_CHUNK * cb;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
          make_float2(out[4 * j + 2 * r] * a.scale,
                      out[4 * j + 2 * r + 1] * a.scale);
  }
}

// flash_bwd_hw's items, one chunk a column block; an instance a mode
// (HwMode), so that no wgmma chain spans a branch on it
template <int MODE>
__global__ void __launch_bounds__(256, 1) flash_bwd_hf(BwdArgs a, HwArgs x) {
  extern __shared__ float4 smem4[];
  const HfSmem sm(smem4);
  const int per = MODE == HW_ADD ? 1 : x.ncb;
  const int id = blockIdx.x / per;
  const int cb = MODE == HW_ADD ? x.cb : int(blockIdx.x % per);
  const int n_kv = (a.Sk + HB_TILE - 1) / HB_TILE * a.KvH * a.B;
  if (id < n_kv) {
    const int kt = id / (a.KvH * a.B), rest = id % (a.KvH * a.B);
    hf_dkdv<MODE>(a, x, sm, kt, rest % a.KvH, rest / a.KvH, cb);
  } else if constexpr (MODE != HW_ADD) {
    const int j = id - n_kv, nq = (a.Sq + HB_TILE - 1) / HB_TILE;
    const int qt = nq - 1 - j / (a.H * a.B), rest = j % (a.H * a.B);
    hf_dq<MODE>(a, x, sm, qt, rest % a.H, rest / a.H, cb);
  }
}

// one launch of `kernel` (flash_bwd_hw or flash_bwd_hf) over `blocks`
// blocks in clusters of `cluster`
int launch_hw(void (*kernel)(BwdArgs, HwArgs), int smem, const BwdArgs& a,
              const HwArgs& x, size_t blocks, int cluster, cudaStream_t s) {
  if (blocks > 0x7fffffffu) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(blocks));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, x);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

// delta, then one launch of clusters of ncb blocks (ncb <= 8), or ncb
// launches adding each column block's partials into the totals (after
// `delta`'s B H Sq floats in the wrapper's zeroed scratch) and one
// reading them.  bf16: flash_bwd_hw, column blocks of 2-4 chunks;
// float32: flash_bwd_hf, one chunk a column block, a head of one chunk
// (Dh 64) in blocks of their own (HW_ONE: no cluster, no exchange between
// blocks)
template <typename T>
int launch_bwd_wide(const BwdArgs& a, int dh, cudaStream_t s) {
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  using Kernel = void (*)(BwdArgs, HwArgs);
  const Kernel kernels[4] = {
      BF16 ? flash_bwd_hw : flash_bwd_hf<HW_EXCHANGE>,
      BF16 ? flash_bwd_hw : flash_bwd_hf<HW_ADD>,
      BF16 ? flash_bwd_hw : flash_bwd_hf<HW_READ>,
      BF16 ? flash_bwd_hw : flash_bwd_hf<HW_ONE>};   // by HwMode
  const int smem = BF16 ? HW_SMEM_BYTES : HF_SMEM_BYTES;
  const int chunks = BF16 ? HW_MAX_CHUNKS : 1;    // a column block's, at most
  const size_t rows = size_t(a.B) * a.Sq * a.H;
  flash_bwd_delta<T><<<unsigned((rows + 7) / 8), THREADS, 0, s>>>(a, dh);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  HwArgs x{dh, dh / HW_CHUNK, (dh / HW_CHUNK + chunks - 1) / chunks,
           HW_EXCHANGE, 0, nullptr};
  const size_t n_kv = size_t((a.Sk + HB_TILE - 1) / HB_TILE) * a.KvH * a.B;
  const size_t n_q = size_t((a.Sq + HB_TILE - 1) / HB_TILE) * a.H * a.B;
  if (!BF16 && x.ncb == 1) x.mode = HW_ONE;
  if (x.ncb <= HW_CLUSTER)
    return launch_hw(kernels[x.mode], smem, a, x, x.ncb * (n_kv + n_q),
                     x.ncb, s);
  x.tot = a.delta + rows;
  x.mode = HW_ADD;
  for (x.cb = 0; x.cb < x.ncb; ++x.cb) {
    const int e = launch_hw(kernels[HW_ADD], smem, a, x, n_kv, 1, s);
    if (e != 0) return e;
  }
  x.mode = HW_READ;
  return launch_hw(kernels[HW_READ], smem, a, x, x.ncb * (n_kv + n_q), 1, s);
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
    if (dh > 256 && dh % HW_CHUNK == 0) return launch_bwd_wide<T>(a, dh, s);
    return int(cudaErrorInvalidValue);
  } else {                         // float32: every multiple of 64 (the
    if (dh > 0 && dh % HW_CHUNK == 0)   // wrapper pads Dh 96 to 128)
      return launch_bwd_wide<T>(a, dh, s);
    return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv all of it; lse and delta
// float32).  Dh: 64, 96, 128 or 256 in bf16, any multiple of 64 in
// float32 (the wrapper pads its narrower heads, 96 to 128), and in both any
// multiple of 64 past 256.  `delta` is the scratch: B H Sq floats, and for
// a head of more than 8 column blocks (bf16 Dh > 2048, float32 Dh > 512)
// then B H nq nk 8192 zeroed floats of S / dP totals (nq, nk: 64-row tiles
// of Sq, Sk).  dk / dv are written whole (zeros where no query sees a
// key).  Two launches in both dtypes (delta, then one; past 8 column
// blocks ncb + 2) on `stream`, no synchronisation, no allocation; returns
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
