// Blocked online-softmax attention for Hopper (sm_90a): causal,
// sliding-window or bidirectional, grouped-query, float32 or bfloat16.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention.py:
// _flash_kernel (launcher `flash_attention`, its pallas_call).  That kernel
// walks (batch, head, q block, kv block) with the kv axis sequential and
// keeps the running max m, sum l and accumulator acc in VMEM scratch.  Here
// one thread block owns one (batch, head, 64-row query tile) and loops over
// the kv tiles itself; m, l and acc live in registers, so nothing carries
// between blocks.
//
// Layout: q (B, Sq, H, Dh), k/v (B, Sk, KvH, Dh), o like q, all contiguous;
// query head h reads kv head h / (H / KvH).  Each kv tile (64 keys) is
// staged in shared memory as float32; the query tile stays there for the
// whole loop.  256 threads: thread (ti, tj) = (tid / 16, tid % 16) owns
// query rows ti + 16 r (r < 4), score columns tj + 16 c (c < 4) and output
// columns 64 g + 4 tj .. + 3.  The 16 threads of a row group sit in one
// half-warp, so row max and row sum are shuffles.  Smem row strides are
// padded (Dh + 4, 64 + 16) so the float4 reads are free of bank conflicts.
//
// Semantics follow _flash_kernel line for line: s = (q . k) * scale in
// float32; keys >= Sk, above the diagonal (causal) or at or before
// q - window (window) are set to -1e30; m_new = max(m, rowmax s),
// alpha = exp(m - m_new), p = exp(s - m_new), l = l * alpha + rowsum p
// (p unrounded), acc = acc * alpha + round_to_v_dtype(p) @ v;
// o = acc / max(l, 1e-30) in q's dtype.  kv tiles wholly above the
// causal diagonal are skipped, as the Pallas kernel's `pl.when` does.
//
// What bounds it: at the slice's shape (B = 2, S = 4096, H = 32, Dh = 64,
// causal, bf16) the work is ~137 GFLOP of products against ~134 MB of
// traffic, so it is bound by operations: ~0.14 ms at the bf16 tensor-core
// peak.  This first version does the products on the CUDA cores in
// float32 (fmaf over float4 reads of shared memory, 4 x 4 register tiles),
// so its ceiling is the float32 rate, ~15x lower; tensor cores (mma.sync /
// wgmma) and TMA-fed tiles are the next step.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per kv tile
constexpr int THREADS = 256;
constexpr int PS = BK + 16;        // smem row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KvH;
  int causal, window;              // window < 0: none
  float scale;
};

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 4) + 2 * BK * (DH + 4) + BQ * PS;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_kernel(FlashArgs a) {
  constexpr int DS = DH + 4;       // smem row stride of the Q/K/V tiles
  constexpr int NG = DH / 64;      // groups of 64 output columns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * DS;
  float* vs = ks + BK * DS;
  float* ps = vs + BK * DS;

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KvH);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH, qi = q0 + r;
    qs[r * DS + d] = qi < a.Sq
        ? to_f(q[((size_t(b) * a.Sq + qi) * a.H + h) * DH + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NG; ++e) acc[r][e] = 0.f;
  }

  int nk = (a.Sk + BK - 1) / BK;
  if (a.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // skip above diagonal
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // the previous tile's readers are done
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int r = idx / DH, d = idx % DH, kj = k0 + r;
      const size_t off = ((size_t(b) * a.Sk + kj) * a.KvH + kvh) * DH + d;
      ks[r * DS + d] = kj < a.Sk ? to_f(k[off]) : 0.f;
      vs[r * DS + d] = kj < a.Sk ? to_f(v[off]) : 0.f;
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
        ps[(ti + 16 * r) * PS + tj + 16 * c] = to_f(from_f<T>(p));
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
          const float4 vv = *reinterpret_cast<const float4*>(
              &vs[(j + jj) * DS + 64 * g + 4 * tj]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y
                          : jj == 2 ? pr[r].z : pr[r].w;
            acc[r][4 * g + 0] = fmaf(p, vv.x, acc[r][4 * g + 0]);
            acc[r][4 * g + 1] = fmaf(p, vv.y, acc[r][4 * g + 1]);
            acc[r][4 * g + 2] = fmaf(p, vv.z, acc[r][4 * g + 2]);
            acc[r][4 * g + 3] = fmaf(p, vv.w, acc[r][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ti + 16 * r;
    if (qi >= a.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* row = o + (size_t(b) * a.Sq + qi) * a.H * DH + size_t(h) * DH;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[64 * g + 4 * tj + e] = from_f<T>(acc[r][4 * g + e] / den);
  }
}

template <typename T, int DH>
int launch(const FlashArgs& a, cudaStream_t s) {
  const int bytes = smem_floats<DH>() * int(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_kernel<T, DH><<<grid, THREADS, bytes, s>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16.  Launches on `stream`, does not synchronise, allocates
// nothing; returns a CUDA error code (0 = success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int KvH, int Dh, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 1 || H < 1 || KvH < 1 || H % KvH != 0 ||
      B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  const FlashArgs a{q, k, v, o, B, Sq, Sk, H, KvH, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64) return launch<float, 64>(a, s);
  if (dtype == 0 && Dh == 128) return launch<float, 128>(a, s);
  if (dtype == 1 && Dh == 64) return launch<__nv_bfloat16, 64>(a, s);
  if (dtype == 1 && Dh == 128) return launch<__nv_bfloat16, 128>(a, s);
  return int(cudaErrorInvalidValue);
}
#endif
