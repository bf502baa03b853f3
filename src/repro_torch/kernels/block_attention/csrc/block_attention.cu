// Facet-layout decode attention for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces: src/repro/kernels/block_attention/block_attention.py::decode_attention
// (the Pallas kernel `_kernel`).  One GQA decode step: for every batch row b
// and query head h, softmax(q . K^T / sqrt(D)) . V over the valid prefix
// pos < lengths[b] of a block-layout KV cache (B, nb, Hkv, bs, D), whose
// (bs, D) extents are the contiguous bursts of the CFA layout.
//
// What bounds it: memory.  Each cached K/V element is read once and used for
// G = Hq/Hkv query heads (G = 2 for qwen3), so the work is a few flops per
// byte, far below the card's ~20 f32 flops per byte: the least time is the
// valid K/V prefix plus q and out over 3.35 TB/s.
//
// Design (simple and right first):
// * one CTA per (kv head, batch row) serves its G query heads, so each K/V
//   element is loaded once for all of them;
// * the CTA walks key tiles of kTile positions over [0, length) only: keys
//   past the valid prefix are never read, and a partial tile masks its tail
//   to -inf.  A position maps to (block, row) = (pos / bs, pos % bs), so a
//   tile may straddle two blocks;
// * each tile's K and V rows are first copied into shared memory as f32 by
//   all threads at once (coalesced along D, all loads in flight together),
//   so the products below read shared memory at consecutive addresses;
// * scores: one warp per key, the lanes split D, one shuffle reduction per
//   query head; online softmax with f32 running max m, denominator l and
//   numerator acc in shared memory, with the Pallas kernel's guard (a fully
//   masked tile leaves the state as it was: alpha = 1, p = 0);
// * out = acc / l, rounded once to q's type (f32 or bf16); K/V are f32 or
//   bf16 (the model's cache is bf16 also when it computes in f32);
// * exact expf and IEEE division (no fast math), f32 accumulation with
//   explicit fused multiply-adds.
// At qwen3's 8 kv heads and 8 lanes that is 64 CTAs for 132 SMs; splitting
// the key range over several CTAs (split-K plus a combine) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // key positions per tile
constexpr int kMaxD = 256;
constexpr int kMaxPerLane = kMaxD / 32;
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v, const int* __restrict__ lengths,
                        QT* __restrict__ out, int Hq, int Hkv, int nb, int bs, int D) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int h = blockIdx.x;   // kv head
  const int b = blockIdx.y;   // batch row
  float* qs = smem;               // [G][D]  queries of this kv head, f32
  float* acc = qs + G * D;        // [G][D]  running numerators
  float* s = acc + G * D;         // [G][kTile] scores, then probabilities
  float* m = s + G * kTile;       // [G] running max
  float* l = m + G;               // [G] running denominator
  float* alpha = l + G;           // [G] this tile's rescale factor
  float* ks = alpha + G;          // [kTile][D] this tile's keys, f32
  float* vs = ks + kTile * D;     // [kTile][D] this tile's values, f32

  const QT* qb = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.0f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
  }
  const int length = min(lengths[b], nb * bs);
  const float scale = sqrtf((float)D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row_stride = D;                       // one key row
  const int64_t block_stride = (int64_t)Hkv * bs * D; // one block of all heads
  const KT* kbh = k + (int64_t)b * nb * block_stride + (int64_t)h * bs * D;
  const KT* vbh = v + (int64_t)b * nb * block_stride + (int64_t)h * bs * D;
  __syncthreads();

  for (int base = 0; base < length; base += kTile) {
    // 0. the tile's valid K and V rows into shared memory
    const int n_keys = min(kTile, length - base);
    for (int i = threadIdx.x; i < n_keys * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const int pos = base + j;
      const int64_t off = (int64_t)(pos / bs) * block_stride + (int64_t)(pos % bs) * row_stride + d;
      ks[i] = to_f(kbh[off]);
      vs[i] = to_f(vbh[off]);
    }
    __syncthreads();
    // 1. scores of this tile's keys, one warp per key
    for (int j = warp; j < kTile; j += kWarps) {
      const int pos = base + j;
      if (pos < length) {
        const float* kr = ks + j * D;
        for (int g = 0; g < G; ++g) {
          float part = 0.0f;
#pragma unroll
          for (int i = 0; i < kMaxPerLane; ++i) {
            const int d = lane + 32 * i;
            if (d < D) part = __fmaf_rn(qs[g * D + d], kr[d], part);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
          if (lane == 0) s[g * kTile + j] = part / scale;
        }
      } else if (lane == 0) {
        for (int g = 0; g < G; ++g) s[g * kTile + j] = -INFINITY;
      }
    }
    __syncthreads();
    // 2. online softmax per query head, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s + g * kTile;
      float mx = -INFINITY;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, sg[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      const bool finite = isfinite(m_new);
      float sum = 0.0f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = finite ? expf(sg[j] - m_new) : 0.0f;
        sg[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float a = finite ? expf(m_prev - m_new) : 1.0f;
        alpha[g] = a;
        m[g] = m_new;
        l[g] = l[g] * a + sum;
      }
    }
    __syncthreads();
    // 3. acc = acc * alpha + p . V, each thread owning fixed (g, d) entries
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      const float* pg = s + g * kTile;
      float a = 0.0f;
      for (int j = 0; j < n_keys; ++j) a = __fmaf_rn(pg[j], vs[j * D + d], a);
      acc[i] = acc[i] * alpha[g] + a;
    }
    __syncthreads();
  }

  QT* ob = out + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) ob[i] = from_f<QT>(acc[i] / l[i / D]);
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)2 * G * D + (size_t)G * kTile + 3 * (size_t)G +
                          (size_t)2 * kTile * D);
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   int B, int Hq, int Hkv, int nb, int bs, int D, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(G, D);
  auto kernel = decode_attention_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), lengths,
      static_cast<QT*>(out), Hq, Hkv, nb, bs, D);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success);
// 1 (cudaErrorInvalidValue) for shapes the kernel does not take.
extern "C" int decode_attention(int q_dtype, int kv_dtype, const void* q, const void* k,
                                const void* v, const int* lengths, void* out, int B, int Hq,
                                int Hkv, int nb, int bs, int D, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD || nb <= 0 || bs <= 0 ||
      B > 65535 || smem_bytes(Hq / Hkv, D) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch<float, float>(q, k, v, lengths, out, B, Hq, Hkv, nb, bs, D, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, lengths, out, B, Hq, Hkv, nb, bs,
                                                     D, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(q, k, v, lengths, out, B, Hq, Hkv, nb, bs, D, st);
  return (int)cudaErrorInvalidValue;
}
