// Mamba2 SSD chunked scan for Hopper (sm_90a) [arXiv:2405.21060], from a
// zero state, returning y only; float32 or bfloat16 x/B/C.
//
// Replaces the TPU Pallas kernel src/repro/kernels/ssd_scan.py:_ssd_kernel
// (launcher `ssd_scan`, its pallas_call).  That kernel walks (batch, head,
// chunk) with the chunk axis sequential and keeps the (P, N) float32 state
// in VMEM scratch.  Here one thread block owns one (batch, head) and loops
// over the chunks in order; the state lives in shared memory (transposed,
// (N, P): 16 KB at N = 64, 32 KB at N = 128), so nothing carries between
// blocks.
//
// Per chunk of L = 64 rows, all in float32 (as _ssd_kernel):
//   dA = dt * A, cA = inclusive cumsum(dA)            (thread 0, in order)
//   W[i][j] = (C_i . B_j) * exp(cA_i - cA_j) for i >= j, else 0
//             (exp only ever sees a non-positive argument)
//   y_i = sum_j W[i][j] (dt_j x_j) + (C_i . state) * exp(cA_i)
//   state <- state * exp(cA_last) + sum_j B_j (x_j dt_j exp(cA_last - cA_j))
// B/C head: h / (H / G).  A ragged tail (s not a multiple of L) is read as
// x = B = C = 0, dt = 0 — the reference's dt = 0 padding, which leaves the
// state unchanged — and its rows are not written.
//
// Layout: x/y (b, s, h, p), dt (b, s, h) float32, A (h,) float32, B/C
// (b, s, g, n), all contiguous.  256 threads: thread (ti, tj) = (tid / 16,
// tid % 16) owns rows ti + 16 r and columns tj + 16 c of each product's
// output, so reads along a row are broadcasts and reads along a column hit
// neighbouring banks (row strides padded to n + 1 and L + 16).
//
// What bounds it: at the slice's shape (b = 2, s = 4096, h = 64, p = 64,
// g = 1, n = 64, bf16) a call moves ~137 MB (~0.041 ms at 3.35 TB/s) and
// does ~13 GFLOP of products, so it is bound by bytes.  This first version
// is far from that: b * h = 128 blocks is under one wave of the 132 SMs, a
// block runs its 64 chunks one after another with one block per SM, and the
// products run on the CUDA cores in float32.  Splitting the chunk axis
// across blocks (a second pass for the state carry) and tensor-core
// products are a later PR's work.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  int b, s, h, g;
};

template <int L, int P, int N>
constexpr int smem_floats() {
  // x*dt, B, C, W, state^T, dt, cA, exp(cA_last - cA), exp(cA)
  return L * P + 2 * L * (N + 1) + L * (L + 16) + N * P + 4 * L;
}

template <typename T, int L, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_kernel(SsdArgs a) {
  static_assert(L % 16 == 0 && P % 16 == 0 && N % 16 == 0, "tile sizes");
  constexpr int BS = N + 1;        // smem row stride of B and C
  constexpr int WS = L + 16;       // smem row stride of W
  constexpr int RL = L / 16, RP = P / 16, RN = N / 16;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // (L, P): x, then x * dt
  float* bs = xs + L * P;                         // (L, BS)
  float* cs = bs + L * BS;                        // (L, BS)
  float* ws = cs + L * BS;                        // (L, WS)
  float* st = ws + L * WS;                        // (N, P) state^T
  float* dts = st + N * P;                        // (L,)
  float* cas = dts + L;                           // (L,)
  float* dec = cas + L;                           // (L,)
  float* eca = dec + L;                           // (L,)

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int gg = hh / (a.h / a.g);
  const float A = a.A[hh];
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  T* y = static_cast<T*>(a.y);

  for (int idx = tid; idx < N * P; idx += THREADS) st[idx] = 0.f;

  const int nc = (a.s + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    for (int idx = tid; idx < L * P; idx += THREADS) {
      const int r = idx / P, pp = idx % P, t = t0 + r;
      xs[idx] = t < a.s
          ? to_f(x[((size_t(bb) * a.s + t) * a.h + hh) * P + pp]) : 0.f;
    }
    for (int idx = tid; idx < L * N; idx += THREADS) {
      const int r = idx / N, nn = idx % N, t = t0 + r;
      const size_t off = ((size_t(bb) * a.s + t) * a.g + gg) * N + nn;
      bs[r * BS + nn] = t < a.s ? to_f(Bm[off]) : 0.f;
      cs[r * BS + nn] = t < a.s ? to_f(Cm[off]) : 0.f;
    }
    if (tid < L) {
      const int t = t0 + tid;
      dts[tid] = t < a.s ? a.dt[(size_t(bb) * a.s + t) * a.h + hh] : 0.f;
    }
    __syncthreads();

    if (tid == 0) {                 // inclusive cumsum of dA, in order
      float run = 0.f;
      for (int r = 0; r < L; ++r) {
        run = run + dts[r] * A;
        cas[r] = run;
      }
    }
    for (int idx = tid; idx < L * P; idx += THREADS) xs[idx] *= dts[idx / P];
    __syncthreads();

    // W = (C B^T) o decay; the per-row exponentials for the next phases
    {
      float cb[RL][RL];
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int q = 0; q < RL; ++q) cb[r][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RL], bv[RL];
#pragma unroll
        for (int r = 0; r < RL; ++r) cv[r] = cs[(ti + 16 * r) * BS + n];
#pragma unroll
        for (int q = 0; q < RL; ++q) bv[q] = bs[(tj + 16 * q) * BS + n];
#pragma unroll
        for (int r = 0; r < RL; ++r)
#pragma unroll
          for (int q = 0; q < RL; ++q) cb[r][q] = fmaf(cv[r], bv[q], cb[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int q = 0; q < RL; ++q) {
          const int i = ti + 16 * r, j = tj + 16 * q;
          ws[i * WS + j] = i >= j ? cb[r][q] * expf(cas[i] - cas[j]) : 0.f;
        }
      if (tid < L) {
        dec[tid] = expf(cas[L - 1] - cas[tid]);
        eca[tid] = expf(cas[tid]);
      }
    }
    __syncthreads();

    // y = W (x dt) + (C state^T) exp(cA)
    {
      float yi[RL][RP], yo[RL][RP];
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int q = 0; q < RP; ++q) yi[r][q] = yo[r][q] = 0.f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        float wv[RL], xv[RP];
#pragma unroll
        for (int r = 0; r < RL; ++r) wv[r] = ws[(ti + 16 * r) * WS + j];
#pragma unroll
        for (int q = 0; q < RP; ++q) xv[q] = xs[j * P + tj + 16 * q];
#pragma unroll
        for (int r = 0; r < RL; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) yi[r][q] = fmaf(wv[r], xv[q], yi[r][q]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RL], sv[RP];
#pragma unroll
        for (int r = 0; r < RL; ++r) cv[r] = cs[(ti + 16 * r) * BS + n];
#pragma unroll
        for (int q = 0; q < RP; ++q) sv[q] = st[n * P + tj + 16 * q];
#pragma unroll
        for (int r = 0; r < RL; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) yo[r][q] = fmaf(cv[r], sv[q], yo[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int i = ti + 16 * r, t = t0 + i;
        if (t >= a.s) continue;
        T* row = y + ((size_t(bb) * a.s + t) * a.h + hh) * P;
#pragma unroll
        for (int q = 0; q < RP; ++q)
          row[tj + 16 * q] = from_f<T>(yi[r][q] + yo[r][q] * eca[i]);
      }
    }
    __syncthreads();               // every read of the old state is done

    // state^T[n][p] <- state^T[n][p] * exp(cA_last) + sum_j B[j][n] xdd[j][p]
    {
      const float e_last = expf(cas[L - 1]);
      float u[RN][RP];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < RP; ++q) u[r][q] = 0.f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        float bv[RN], xv[RP];
        const float dj = dec[j];
#pragma unroll
        for (int r = 0; r < RN; ++r) bv[r] = bs[j * BS + ti + 16 * r];
#pragma unroll
        for (int q = 0; q < RP; ++q) xv[q] = xs[j * P + tj + 16 * q] * dj;
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) u[r][q] = fmaf(bv[r], xv[q], u[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          float* sp = &st[(ti + 16 * r) * P + tj + 16 * q];
          *sp = *sp * e_last + u[r][q];
        }
    }
    __syncthreads();               // the next chunk overwrites the tiles
  }
}

template <typename T, int L, int P, int N>
int launch(const SsdArgs& a, cudaStream_t s) {
  const int bytes = smem_floats<L, P, N>() * int(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, L, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(a.h, a.b);
  ssd_kernel<T, L, P, N><<<grid, THREADS, bytes, s>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 (x, B, C and y; dt and A are float32).  Supported:
// chunk 64, p 64, n 64 or 128.  Launches on `stream`, does not
// synchronise, allocates nothing; returns a CUDA error code (0 = success).
extern "C" int ssd_scan_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, void* y, int b, int s, int h, int p, int g, int n,
    int chunk, int dtype, void* stream) {
  if (b < 0 || s < 0 || h < 1 || g < 1 || h % g != 0 || b > 65535)
    return int(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return 0;
  const SsdArgs a{x, dt, A, B, C, y, b, s, h, g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk != 64 || p != 64) return int(cudaErrorInvalidValue);
  if (dtype == 0 && n == 64) return launch<float, 64, 64, 64>(a, st);
  if (dtype == 0 && n == 128) return launch<float, 64, 64, 128>(a, st);
  if (dtype == 1 && n == 64) return launch<__nv_bfloat16, 64, 64, 64>(a, st);
  if (dtype == 1 && n == 128) return launch<__nv_bfloat16, 64, 64, 128>(a, st);
  return int(cudaErrorInvalidValue);
}
#endif
