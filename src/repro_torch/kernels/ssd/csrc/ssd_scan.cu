// Chunked Mamba2 SSD scan for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces: src/repro/kernels/ssd/ssd.py::ssd_scan (the Pallas kernel
// `_kernel`).  Per batch row b and head h, with state S in R^{P x N} and the
// decay a_t = exp(loga_t), it computes S_t = a_t S_{t-1} + x_t (outer) B_t and
// y_t = S_t C_t in chunks of L steps.  With l the running log-decay cumsum
// within a chunk:
//
//   y[t]   = sum_{s<=t} exp(l_t - l_s) (C_t . B_s) x_s  +  exp(l_t) S_prev C_t
//   S_next = exp(l_L) S_prev + sum_s exp(l_L - l_s) x_s (outer) B_s
//
// The state carried from chunk to chunk is the chunk's CFA flow-out facet.
//
// What bounds it: arithmetic.  Per chunk and head it does about L^2 N (the
// C.B products, lower half) + L^2 P + 4 L P N flops against L (P + 2N)
// elements read, so the least time is the flops over 67 TFLOP/s f32 (the
// bound counts the full 2 L^2 N + 2 L^2 P + 4 L P N, as the Pallas kernel
// computes it): about 25 us for mamba2-370m's 32 heads x 1024 steps.
//
// Design (simple and right first):
// * one CTA of 1024 threads per (head, batch row) walks the chunks in order
//   (one such CTA per SM at full width, so the warps hide the latency the
//   chunk's serial phases expose), the (P, N) f32
//   state in shared memory, stored transposed as St[n][p] (32 KB at P 64,
//   N 128), beside the chunk's x as f32 (L x P), the lower triangle of the
//   decay-weighted C.B matrix W (L x L) and the chunk's cumulative
//   log-decays;
// * B and C (head-independent, (L, N) per chunk) are read from global memory
//   through L1/L2, which the 32 heads of a row share: C_t . B_s with one warp
//   per (t, s) pair and the lanes along n (coalesced rows, a shuffle
//   reduction); in the two P-wide products a warp's lanes share one t (or
//   one n), so each B/C read is one broadcast;
// * thread mappings keep shared memory free of bank conflicts: y and the
//   state update run with p fastest over the lanes, reading x[s][p] and
//   St[n][p] at consecutive addresses;
// * only the s <= t half of the decay matrix is formed: exp(l_t - l_s) is
//   taken for l_t - l_s <= 0 only, so no inf is ever multiplied by a masked
//   zero (the Pallas kernel exponentiates the whole matrix and masks after);
// * the chunk length is a runtime argument (L <= 128: the model uses
//   min(chunk, T), the smoke configs 8); N <= 256; f32 accumulation with
//   explicit fused multiply-adds, y rounded once to x's type (f32 or bf16),
//   the final state written in f32 as (P, N);
// * exact expf, no fast math; the chunk's log-decays are loaded in parallel
//   and summed serially by one thread.
// The contractions run on the FP32 pipes; tensor-core tiles for the three
// chunk products (and more CTAs per head at small batch) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kMaxN = 256;
constexpr int kMaxPerLane = kMaxN / 32;
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int P, int N, int L) {
  return sizeof(float) * ((size_t)P * N + (size_t)L * P + (size_t)L * L + 3 * (size_t)L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ loga,
                const T* __restrict__ Bm, const T* __restrict__ C, T* __restrict__ y,
                float* __restrict__ state_out, int Tlen, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* St = smem;             // [N][P] running state (the facet), transposed
  float* xs = St + P * N;       // [L][P] this chunk's x, f32
  float* W = xs + L * P;        // [L][L] exp(l_t - l_s) C_t.B_s, s <= t
  float* lcum = W + L * L;      // [L] cumulative log-decay
  float* el = lcum + L;         // [L] exp(l_t)
  float* wout = el + L;         // [L] exp(l_L - l_s)

  const int64_t row = (int64_t)H * P;  // x / y elements per time step
  const T* xb = x + (int64_t)b * Tlen * row + (int64_t)h * P;
  T* yb = y + (int64_t)b * Tlen * row + (int64_t)h * P;
  const float* lb = loga + (int64_t)b * Tlen * H + h;
  const T* Bb = Bm + (int64_t)b * Tlen * N;
  const T* Cb = C + (int64_t)b * Tlen * N;

  for (int i = threadIdx.x; i < P * N; i += kThreads) St[i] = 0.0f;

  for (int c0 = 0; c0 < Tlen; c0 += L) {
    for (int i = threadIdx.x; i < L * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      xs[i] = to_f(xb[(int64_t)(c0 + t) * row + p]);
    }
    for (int t = threadIdx.x; t < L; t += kThreads) lcum[t] = lb[(int64_t)(c0 + t) * H];
    __syncthreads();
    if (threadIdx.x == 0) {
      float acc = 0.0f;
      for (int t = 0; t < L; ++t) {
        acc += lcum[t];
        lcum[t] = acc;
      }
    }
    __syncthreads();
    const float ltot = lcum[L - 1];
    for (int t = threadIdx.x; t < L; t += kThreads) {
      el[t] = expf(lcum[t]);
      wout[t] = expf(ltot - lcum[t]);
    }
    // intra-chunk weights, lower triangle only: one warp per (t, s), lanes along n
    for (int t = warp; t < L; t += kWarps) {
      const T* ct = Cb + (int64_t)(c0 + t) * N;
      float cv[kMaxPerLane];
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int n = lane + 32 * i;
        cv[i] = n < N ? to_f(ct[n]) : 0.0f;
      }
      for (int s = 0; s <= t; ++s) {
        const T* bs = Bb + (int64_t)(c0 + s) * N;
        float g = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          const int n = lane + 32 * i;
          if (n < N) g = __fmaf_rn(cv[i], to_f(bs[n]), g);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) g += __shfl_xor_sync(0xffffffffu, g, off);
        if (lane == 0) W[t * L + s] = expf(lcum[t] - lcum[s]) * g;
      }
    }
    __syncthreads();
    // y = intra + exp(l_t) * (S_prev . C_t), p fastest over the lanes
    for (int i = threadIdx.x; i < L * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      float intra = 0.0f;
      const float* wt = W + t * L;
      for (int s = 0; s <= t; ++s) intra = __fmaf_rn(wt[s], xs[s * P + p], intra);
      const T* ct = Cb + (int64_t)(c0 + t) * N;
      float cs = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) cs = __fmaf_rn(to_f(ct[n]), St[n * P + p], cs);
      yb[(int64_t)(c0 + t) * row + p] = from_f<T>(__fmaf_rn(el[t], cs, intra));
    }
    __syncthreads();
    // flow-out facet: S <- exp(l_L) S + sum_s exp(l_L - l_s) x_s B_s, p fastest
    const float etot = expf(ltot);
    for (int i = threadIdx.x; i < P * N; i += kThreads) {
      const int n = i / P, p = i - n * P;
      const T* bn = Bb + (int64_t)c0 * N + n;
      float ds = 0.0f;
#pragma unroll 4
      for (int s = 0; s < L; ++s) ds = __fmaf_rn(xs[s * P + p] * wout[s], to_f(bn[(int64_t)s * N]), ds);
      St[i] = __fmaf_rn(etot, St[i], ds);
    }
    __syncthreads();
  }
  float* so = state_out + ((int64_t)b * H + h) * P * N;
  for (int i = threadIdx.x; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    so[i] = St[n * P + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* loga, const void* Bm, const void* C, void* y,
                   float* state, int Bsz, int Tlen, int H, int P, int N, int L,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, L);
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(H, Bsz), kThreads, smem, stream>>>(
      static_cast<const T*>(x), loga, static_cast<const T*>(Bm), static_cast<const T*>(C),
      static_cast<T*>(y), state, Tlen, H, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// dtype code (x, B, C and y): 0 = float32, 1 = bfloat16; loga and the state
// are float32.  Returns a cudaError_t (0 = success); 1
// (cudaErrorInvalidValue) for shapes the kernel does not take.
extern "C" int ssd_scan(int dtype, const void* x, const float* loga, const void* Bm,
                        const void* C, void* y, float* state, int Bsz, int Tlen, int H, int P,
                        int N, int L, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || H <= 0 || P <= 0 || N <= 0 || N > kMaxN || L <= 0 ||
      L > kMaxChunk ||
      Tlen <= 0 || Tlen % L != 0 || smem_bytes(P, N, L) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, loga, Bm, C, y, state, Bsz, Tlen, H, P, N, L, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, loga, Bm, C, y, state, Bsz, Tlen, H, P, N, L, st);
  return (int)cudaErrorInvalidValue;
}
