// The Mamba2 block's epilogue for Hopper (sm_90a), forward and backward, bound
// to PyTorch via ctypes.
//
// Replaces no TPU kernel: the reference package leaves this step to XLA,
// which fuses it on the TPU.  Eager PyTorch runs it as about 17 kernels
// forward and some 30 backward, each a pass over (rows, H*P) tensors, and at
// the training shape those passes took about a third of a mamba2 step's
// elementwise device time.  Per row (one token) of H*P channels:
//
//   u   = y + bf(D_h) * xh                 (xh the scan's input, head h)
//   s   = silu(z) = z * (1 / (1 + exp(-z)))
//   g   = u * s
//   out = g * rsqrt(mean(g^2) + eps) * w   (f32, then the compute dtype)
//
// What bounds it: bytes.  The forward reads y, xh and z and writes out (and
// rstd, 4 B a row); at the training shape (32768 rows of 2048 channels,
// bf16) that is 537 MB, 0.160 ms at 3.35 TB/s.  The backward reads y, xh, z
// and the output's gradient and writes the gradients of y, xh and z: 940 MB,
// 0.281 ms; its per-CTA partial sums of dD and dw are 2-4 MB more, read once.
// A few exp and IEEE divisions per element stay well under the memory time.
//
// Design:
// * forward: one CTA per row; each thread holds CHUNKS vectors of 16 bytes
//   (8 bf16 or 4 f32 channels, within one head) of g in registers, the row's
//   sum of squares goes by warp shuffles and then over the warps in order, so
//   the row is read once and written once.  At mamba2's 2048 channels, 256
//   threads x 8 bf16 in one pass; wider rows (jamba) loop over the row;
// * rounding: the kernel rounds to the input's dtype at exactly the points
//   where the eager chain does — D's cast, D * xh, the sum, each of silu's
//   steps (-z, expf, 1 + e, 1 / d by IEEE division, z * r) and the gate
//   product — and the norm runs in f32 as the eager chain's does: the square,
//   the mean (times PyTorch's mean factor, rows / (rows * H*P) in f32), + eps,
//   rsqrtf, x rstd, x w, one downcast.  Built with -fmad=false, so no product
//   is contracted into an add.  Only the sum of squares runs in another order
//   than PyTorch's reduction;
// * backward: persistent CTAs, each walking rows blockIdx.x, + gridDim.x, ...
//   It recomputes u, s, g and x^ = g * rstd from the saved inputs and rstd,
//   reduces sum(dx^ * x^) over the row like the forward's sum, and computes
//   in f32:  dg = rstd (dx^ - x^ mean(dx^ x^)),  du = dg s,
//   dz = dg u sigma(z) (1 + z (1 - sigma(z))),  dy = du,  dxh = du bf(D_h);
//   each gradient is rounded once to its tensor's dtype.  dw and dD are
//   summed in registers over the CTA's rows and written as one row of
//   per-CTA partials; a second launch sums the partials over the CTAs in a
//   fixed order.  No atomics: two calls give the same bits;
// * one or two launches per call, no host read, no allocation (the wrapper
//   allocates outputs and scratch): capturable in a CUDA graph.
// Every kernel's name holds "norm": the benchmark's frozen kernel classes
// count such kernels as elementwise work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSumThreads = 512;  // the partial sums' launch: 16 warps x 32 columns

// f32 <-> storage type, and the rounding of an f32 value to the storage type
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// an element's bits, for 16-byte accesses through a union
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = float;
  static __device__ __forceinline__ float get(float b) { return b; }
  static __device__ __forceinline__ float put(float v) { return v; }
};
template <>
struct Bits<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float get(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ unsigned short put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// One vector: the VEC = 16 / sizeof(T) contiguous elements of a 16-byte access
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[kVec<T>]) {
  union { uint4 raw; typename Bits<T>::type e[kVec<T>]; } u;
  u.raw = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) v[i] = Bits<T>::get(u.e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[kVec<T>]) {
  union { uint4 raw; typename Bits<T>::type e[kVec<T>]; } u;
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) u.e[i] = Bits<T>::put(v[i]);
  *reinterpret_cast<uint4*>(p) = u.raw;
}

// VEC f32 values (the norm's scale, a vector's worth), as float4 accesses
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* __restrict__ p, const float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) p[i] = v[i];
}

// The gated product as the eager chain rounds it: u = y + bf(D) xh,
// s = silu(z), g = u s, each step rounded to T.  `ef` returns exp(-z) in f32.
template <typename T>
__device__ __forceinline__ void gate(float y, float xh, float z, float Dh, float& u, float& s,
                                     float& g, float& ef) {
  const float t = rnd<T>(Dh * xh);
  u = rnd<T>(y + t);
  ef = expf(-z);
  const float e = rnd<T>(ef);
  const float d = rnd<T>(1.0f + e);
  const float r = rnd<T>(1.0f / d);
  s = rnd<T>(z * r);
  g = rnd<T>(u * s);
}

// The block's sum of v: a warp butterfly (every lane ends with the same
// value), then the warps' sums added in warp order by every thread.  The
// same order in every call.  `red` holds 32 floats; the trailing barrier lets
// the caller use it again.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) t += red[i];
  __syncthreads();
  return t;
}

template <typename T, int CHUNKS>
__global__ void __launch_bounds__(kMaxThreads)
gated_rms_norm_fwd_kernel(const T* __restrict__ y, const T* __restrict__ xh,
                          const T* __restrict__ z, const float* __restrict__ D,
                          const float* __restrict__ w, T* __restrict__ out,
                          float* __restrict__ rstd, int HP, int P, float inv_n, float eps) {
  constexpr int VEC = kVec<T>;
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * HP;
  float g[CHUNKS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int c0 = (k * blockDim.x + threadIdx.x) * VEC;
    if (c0 < HP) {
      float yv[VEC], xv[VEC], zv[VEC];
      load_vec<T>(y + base + c0, yv);
      load_vec<T>(xh + base + c0, xv);
      load_vec<T>(z + base + c0, zv);
      const float Dh = rnd<T>(D[c0 / P]);  // VEC divides P: one head per vector
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float u, s, ef;
        gate<T>(yv[i], xv[i], zv[i], Dh, u, s, g[k][i], ef);
        const float sq = g[k][i] * g[k][i];
        ss += sq;
      }
    }
  }
  ss = block_sum(ss, red);
  const float rs = rsqrtf(ss * inv_n + eps);
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int c0 = (k * blockDim.x + threadIdx.x) * VEC;
    if (c0 < HP) {
      float wv[VEC], o[VEC];
      load_f32<VEC>(w + c0, wv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = g[k][i] * rs;
        o[i] = xhat * wv[i];
      }
      store_vec<T>(out + base + c0, o);
    }
  }
  if (rstd != nullptr && threadIdx.x == 0) rstd[blockIdx.x] = rs;
}

template <typename T, int CHUNKS>
__global__ void __launch_bounds__(kMaxThreads)
gated_rms_norm_bwd_kernel(const T* __restrict__ y, const T* __restrict__ xh,
                          const T* __restrict__ z, const T* __restrict__ dout,
                          const float* __restrict__ D, const float* __restrict__ w,
                          const float* __restrict__ rstd, T* __restrict__ dy,
                          T* __restrict__ dxh, T* __restrict__ dz, float* __restrict__ part,
                          int rows, int HP, int P, float inv_n) {
  constexpr int VEC = kVec<T>;
  __shared__ float red[32];
  extern __shared__ float head_part[];  // one dD partial per vector of channels
  float accW[CHUNKS][VEC], accD[CHUNKS];
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    accD[k] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) accW[k][i] = 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = (size_t)row * HP;
    const float rs = rstd[row];
    // kept across the row's reduction: u, s, x^, dx^, xh and silu'(z)
    float u[CHUNKS][VEC], s[CHUNKS][VEC], xhat[CHUNKS][VEC], dxhat[CHUNKS][VEC];
    float xv[CHUNKS][VEC], dsil[CHUNKS][VEC];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int c0 = (k * blockDim.x + threadIdx.x) * VEC;
      if (c0 < HP) {
        float yv[VEC], zv[VEC], dv[VEC], wv[VEC];
        load_vec<T>(y + base + c0, yv);
        load_vec<T>(xh + base + c0, xv[k]);
        load_vec<T>(z + base + c0, zv);
        load_vec<T>(dout + base + c0, dv);
        load_f32<VEC>(w + c0, wv);
        const float Dh = rnd<T>(D[c0 / P]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float g, ef;
          gate<T>(yv[i], xv[k][i], zv[i], Dh, u[k][i], s[k][i], g, ef);
          xhat[k][i] = g * rs;
          dxhat[k][i] = dv[i] * wv[i];
          const float sig = 1.0f / (1.0f + ef);
          dsil[k][i] = sig * (1.0f + zv[i] * (1.0f - sig));
          const float p = dxhat[k][i] * xhat[k][i];
          dot += p;
          const float pw = dv[i] * xhat[k][i];
          accW[k][i] += pw;
        }
      }
    }
    dot = block_sum(dot, red);
    const float mean = dot * inv_n;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int c0 = (k * blockDim.x + threadIdx.x) * VEC;
      if (c0 < HP) {
        const float Dh = rnd<T>(D[c0 / P]);
        float gy[VEC], gx[VEC], gz[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float q = xhat[k][i] * mean;
          const float dg = rs * (dxhat[k][i] - q);
          const float du = dg * s[k][i];
          const float ds = dg * u[k][i];
          gz[i] = ds * dsil[k][i];
          gy[i] = du;
          gx[i] = du * Dh;
          const float pd = du * xv[k][i];
          accD[k] += pd;
        }
        store_vec<T>(dy + base + c0, gy);
        store_vec<T>(dxh + base + c0, gx);
        store_vec<T>(dz + base + c0, gz);
      }
    }
  }
  // this CTA's partials: dw per channel, then dD per head (its vectors' sums
  // in channel order)
  const int H = HP / P;
  float* prow = part + (size_t)blockIdx.x * (HP + H);
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int c0 = (k * blockDim.x + threadIdx.x) * VEC;
    if (c0 < HP) {
      store_f32<VEC>(prow + c0, accW[k]);
      head_part[c0 / VEC] = accD[k];
    }
  }
  __syncthreads();
  const int per = P / VEC;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float t = 0.f;
    for (int i = h * per; i < (h + 1) * per; ++i) t += head_part[i];
    prow[HP + h] = t;
  }
}

// dw and dD: each column of the (ctas, HP + H) partials summed over the CTAs,
// warp j taking CTAs j, j + 16, ... and the 16 warps' sums added in order.
__global__ void __launch_bounds__(kSumThreads)
gated_rms_norm_bwd_sum_kernel(const float* __restrict__ part, int ctas, int HP, int H,
                              float* __restrict__ dw, float* __restrict__ dD) {
  __shared__ float red[kSumThreads / 32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = HP + H;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols)
    for (int k = warp; k < ctas; k += kSumThreads / 32) acc += part[(size_t)k * cols + col];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kSumThreads / 32; ++j) t += red[j][lane];
    if (col < HP) dw[col] = t;
    else dD[col - HP] = t;
  }
}

// PyTorch's mean factor: float(outputs) / numel, in f32
float mean_factor(int rows, int HP) {
  return (float)rows / (float)((long long)rows * HP);
}

// The plan the wrapper picked (`launch_plan` in ops.py): vectors of
// 16 / sizeof(T) elements (P a multiple of that, every row pointer 16-byte
// aligned), CHUNKS one of 1, 2, 4, threads a multiple of 32 that covers HP.
bool plan_ok(int dtype, int chunks, int threads, int HP, int P) {
  if (dtype != 0 && dtype != 1) return false;
  const int vec = dtype == 1 ? kVec<__nv_bfloat16> : kVec<float>;
  if (chunks != 1 && chunks != 2 && chunks != 4) return false;
  if (threads <= 0 || threads > kMaxThreads || threads % 32) return false;
  if (P <= 0 || HP <= 0 || HP % P || P % vec) return false;
  return (long long)threads * chunks * vec >= HP;
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((uintptr_t)p % 16) return false;
  return true;
}

template <typename T>
cudaError_t fwd(int chunks, int threads, int rows, cudaStream_t st, const void* y,
                const void* xh, const void* z, const float* D, const float* w, void* out,
                float* rstd, int HP, int P, float inv_n, float eps) {
  const T* a = static_cast<const T*>(y);
  const T* b = static_cast<const T*>(xh);
  const T* c = static_cast<const T*>(z);
  T* o = static_cast<T*>(out);
  switch (chunks) {
    case 1: gated_rms_norm_fwd_kernel<T, 1><<<rows, threads, 0, st>>>(
        a, b, c, D, w, o, rstd, HP, P, inv_n, eps); break;
    case 2: gated_rms_norm_fwd_kernel<T, 2><<<rows, threads, 0, st>>>(
        a, b, c, D, w, o, rstd, HP, P, inv_n, eps); break;
    default: gated_rms_norm_fwd_kernel<T, 4><<<rows, threads, 0, st>>>(
        a, b, c, D, w, o, rstd, HP, P, inv_n, eps); break;
  }
  return cudaGetLastError();
}

template <typename T>
const void* bwd_pick(int chunks) {
  switch (chunks) {
    case 1: return (const void*)gated_rms_norm_bwd_kernel<T, 1>;
    case 2: return (const void*)gated_rms_norm_bwd_kernel<T, 2>;
    default: return (const void*)gated_rms_norm_bwd_kernel<T, 4>;
  }
}

const void* bwd_kernel(int dtype, int chunks) {
  return dtype == 1 ? bwd_pick<__nv_bfloat16>(chunks) : bwd_pick<float>(chunks);
}

}  // namespace

// dtype code (y, xh, z and out): 0 = float32, 1 = bfloat16; D (H), w (H*P)
// and rstd (rows; null when the caller saves nothing) are float32.  y, xh, z
// and out are (rows, H*P) contiguous, the channel index h * P + p.
// Returns a cudaError_t (0 = success); 1 (cudaErrorInvalidValue) for a plan,
// shape or alignment the kernel does not take.
extern "C" int gated_rms_norm(int dtype, int chunks, int threads, const void* y, const void* xh,
                              const void* z, const float* D, const float* w, void* out,
                              float* rstd, int rows, int HP, int P, float eps, void* stream) {
  if (rows < 0 || !plan_ok(dtype, chunks, threads, HP, P) || !aligned16({y, xh, z, w, out}))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_n = mean_factor(rows, HP);
  return (int)(dtype == 1 ? fwd<__nv_bfloat16>(chunks, threads, rows, st, y, xh, z, D, w, out,
                                               rstd, HP, P, inv_n, eps)
                          : fwd<float>(chunks, threads, rows, st, y, xh, z, D, w, out, rstd,
                                       HP, P, inv_n, eps));
}

// CTAs of the backward's first launch an SM holds at this plan (0 for a plan
// the kernel does not take): the wrapper sizes the persistent grid from it.
extern "C" int gated_rms_norm_bwd_occupancy(int dtype, int chunks, int threads, int HP, int P) {
  if (!plan_ok(dtype, chunks, threads, HP, P)) return 0;
  int n = 0;
  const size_t smem = (size_t)threads * chunks * sizeof(float);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bwd_kernel(dtype, chunks), threads,
                                                    smem) != cudaSuccess)
    return 0;
  return n;
}

// The gradients of gated_rms_norm: dy, dxh (the D term alone) and dz in the
// inputs' dtype, dD (H) and dw (H*P) in float32, from the saved y, xh, z and
// rstd and the output's gradient dout.  `part` is (ctas, H*P + H) float32
// scratch.  Two launches: `ctas` persistent CTAs over the rows, then the
// partials' sums.
extern "C" int gated_rms_norm_bwd(int dtype, int chunks, int threads, int ctas, const void* y,
                                  const void* xh, const void* z, const void* dout,
                                  const float* D, const float* w, const float* rstd, void* dy,
                                  void* dxh, void* dz, float* part, float* dD, float* dw,
                                  int rows, int HP, int P, void* stream) {
  if (rows <= 0 || ctas <= 0 || !plan_ok(dtype, chunks, threads, HP, P) ||
      !aligned16({y, xh, z, dout, w, dy, dxh, dz}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_n = mean_factor(rows, HP);
  const size_t smem = (size_t)threads * chunks * sizeof(float);
  const void* fn = bwd_kernel(dtype, chunks);
  void* args[] = {(void*)&y, (void*)&xh, (void*)&z, (void*)&dout, (void*)&D, (void*)&w,
                  (void*)&rstd, (void*)&dy, (void*)&dxh, (void*)&dz, (void*)&part,
                  (void*)&rows, (void*)&HP, (void*)&P, (void*)&inv_n};
  cudaError_t err = cudaLaunchKernel(fn, dim3(ctas), dim3(threads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  const int H = HP / P;
  gated_rms_norm_bwd_sum_kernel<<<(HP + H + 31) / 32, kSumThreads, 0, st>>>(part, ctas, HP, H,
                                                                            dw, dD);
  return (int)cudaGetLastError();
}
