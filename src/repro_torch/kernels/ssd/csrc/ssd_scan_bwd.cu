// The gradient of the chunked Mamba2 SSD scan for Hopper (sm_90a), bound to
// PyTorch via ctypes.
//
// Replaces: the reverse pass that XLA's autodiff builds for the reference
// model's jnp SSD (src/repro/models/mamba2.py::_ssd_chunked; the Pallas
// kernel src/repro/kernels/ssd/ssd.py::ssd_scan has no VJP).  The forward
// (ssd_scan.cu, per batch row b, head h, state S in R^{P x N}) computes per
// chunk of L steps, with l = cumsum(loga) inside the chunk,
//
//   y_t    = sum_{s<=t} W[t,s] x_s + exp(l_t) S_prev C_t,
//            W[t,s] = exp(l_t - l_s) G[t,s],  G[t,s] = C_t . B_s
//   S_next = exp(l_L) S_prev + sum_s exp(l_L - l_s) x_s (outer) B_s
//
// and saves S_prev of every chunk (the chunk's incoming flow-out facet).
// Given dy and the gradient of the final state, the reverse pass carries dS
// (the gradient of S_next) from the last chunk to the first:
//
//   dS_prev = exp(l_L) dS_next + sum_t exp(l_t) dy_t (outer) C_t
//   dx_s    = sum_{t>=s} W[t,s] dy_t + exp(l_L - l_s) dS_next B_s
//   dG[t,s] = sum_h [s<=t] exp(l_t - l_s) (dy_t . x_s)           (over heads)
//   dC_t    = sum_s dG[t,s] B_s + sum_h exp(l_t) dy_t^T S_prev
//   dB_s    = sum_t dG[t,s] C_t + sum_h exp(l_L - l_s) x_s^T dS_next
//   dl_t    = sum_s A[t,s] - sum_u A[u,t]   (A = W o (dy_t . x_s), s <= t)
//           + exp(l_t) dy_t . (S_prev C_t) - exp(l_L - l_t) x_t . (dS_next B_t)
//           + [t = L-1] (exp(l_L) <dS_next, S_prev> + sum_s exp(l_L - l_s) x_s . (dS_next B_s))
//   dloga_s = sum_{t>=s} dl_t (a reverse cumsum inside the chunk).
//
// B and C are shared by every head and row p, loga by every row p, so dB,
// dC and dloga are sums across what one CTA of the forward's grid owns.
// The reverse pass is four launches on one stream, each sum in a fixed
// order and no atomics, so a call is deterministic (the same inputs give the
// same bits) and capturable in a CUDA graph:
//
//   1. gram    grid (nc, B):              G = C B^T per chunk into scratch;
//   2. dstate  grid (ceil(P/16), H, B):   16 rows p of one head walk the
//      chunks in reverse carrying dS in shared memory; write dx and dS_next
//      of every chunk (scratch, the layout of the saved states);
//   3. dgram   grid (nc, B):              per chunk, over the heads in order:
//      dy . x (register tiles), dG (kept in registers, then written over G)
//      and each head's intra-chunk dl;
//   4. dbc     grid (nc, B):              per chunk and 32-column tile of N,
//      over the heads in order: dy^T S_prev and x^T dS_next (register
//      tiles), their dl terms, then dC and dB with dG's products; last the
//      reverse cumsum of dl into dloga.
//
// Scratch beside the outputs: G/dG (B, nc, L, L) f32 and dS_next (B, nc, H,
// P, N) f32 (268 MB at B 8, T 4096, H 32, P 64, N 128, as much as the saved
// states).  All products are FP32 FMAs out of shared memory (exact fused
// multiply-adds; inputs upcast on load): a first, simple kernel.  x, dy, B
// and C come in float32 or bfloat16; dx, dB and dC go out in that dtype,
// dloga in float32.  L <= 128, N <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPB = 16;     // rows p per CTA of the dstate kernel
constexpr int kMaxChunk = 128;
constexpr int kMaxN = 256;
constexpr int kNT = 64;     // n-tile of the gram and dstate kernels
constexpr int kNT3 = 32;    // n-tile of the dbc kernel
constexpr int kPT = 32;     // p-tile of the dgram and dbc kernels
constexpr int kRT = 8;      // register-tile rows (t) per thread: L / 16
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// inclusive cumsum of the chunk's log-decays of one head: warp 0, four
// consecutive steps per lane, then a shuffle scan over the lanes
__device__ __forceinline__ void load_lcum(float* lc, const float* loga, size_t row0, int H,
                                          int h, int L) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[4];
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      run += t < L ? loga[(row0 + t) * H + h] : 0.0f;
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const float excl = incl - run;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      if (t < L) lc[t] = v[i] + excl;
    }
  }
  __syncthreads();
}

// -- shared memory per kernel, in floats ------------------------------------------
__host__ __device__ inline size_t gram_floats(int L) { return 2 * (size_t)L * (kNT + 1); }
__host__ __device__ inline size_t dstate_floats(int N, int L) {
  return (size_t)kPB * (N + 1) + (size_t)L * kPB + (size_t)L * L + 2 * (size_t)L * (kNT + 1) +
         3 * (size_t)L;
}
__host__ __device__ inline size_t dgram_floats(int L) {
  return (size_t)L * L + 2 * (size_t)L * (kPT + 1) + (size_t)L + 2 * 16 * (size_t)L;
}
__host__ __device__ inline size_t dbc_floats(int L) {
  return (size_t)L * L + 2 * (size_t)L * (kNT3 + 1) + 2 * (size_t)L * (kPT + 1) +
         2 * (size_t)kPT * (kNT3 + 1) + 4 * (size_t)L + 2 * 16 * (size_t)L + kThreads;
}

// 1. G = C B^T per chunk: thread (ty, tx) owns t = ty + 16 i, s = tx + 16 j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ Bm, const T* __restrict__ C, float* __restrict__ G, int Tlen,
            int N, int L) {
  extern __shared__ float sm[];
  float* Cs = sm;                 // [L][kNT + 1]
  float* Bs = Cs + L * (kNT + 1);  // [L][kNT + 1]
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row0 = (size_t)b * Tlen + (size_t)c * L;
  float acc[kRT][kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < kRT; ++j) acc[i][j] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += kNT) {
    const int nt = min(kNT, N - n0);
    for (int i = threadIdx.x; i < L * kNT; i += kThreads) {
      const int t = i / kNT, n = i - t * kNT;
      const bool ok = n < nt;
      Cs[t * (kNT + 1) + n] = ok ? ld(C + (row0 + t) * N + n0 + n) : 0.0f;
      Bs[t * (kNT + 1) + n] = ok ? ld(Bm + (row0 + t) * N + n0 + n) : 0.0f;
    }
    __syncthreads();
    for (int n = 0; n < nt; ++n) {
      float a[kRT], bb[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = ty + 16 * i, s = tx + 16 * i;
        a[i] = t < L ? Cs[t * (kNT + 1) + n] : 0.0f;
        bb[i] = s < L ? Bs[s * (kNT + 1) + n] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kRT; ++j) acc[i][j] = __fmaf_rn(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* g = G + ((size_t)b * nc + c) * L * L;
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < kRT; ++j) {
      const int t = ty + 16 * i, s = tx + 16 * j;
      if (t < L && s < L) g[t * L + s] = acc[i][j];
    }
}

// 2. The reverse walk: 16 rows p of head h carry dS through the chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dstate_kernel(const T* __restrict__ dy, const float* __restrict__ loga, const T* __restrict__ Bm,
              const T* __restrict__ C, const float* __restrict__ G,
              const float* __restrict__ dfinal, float* __restrict__ dstates, T* __restrict__ dx,
              int Tlen, int H, int P, int N, int L) {
  extern __shared__ float sm[];
  const int ldS = N + 1;
  float* dS = sm;                     // [16][N + 1] the carried gradient of the state
  float* dys = dS + kPB * ldS;        // [L][16] the chunk's dy columns
  float* W = dys + L * kPB;           // [L][L] exp(l_t - l_s) G[t,s], s <= t
  float* Bs = W + L * L;              // [L][kNT + 1]
  float* Cs = Bs + L * (kNT + 1);     // [L][kNT + 1]
  float* lcum = Cs + L * (kNT + 1);   // [L]
  float* el = lcum + L;               // [L] exp(l_t)
  float* wout = el + L;               // [L] exp(l_L - l_s)
  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(kPB, P - p0);
  const int nc = Tlen / L;
  const int tp = threadIdx.x % kPB, ts = threadIdx.x / kPB;  // this thread's p and first s

  const float* df = dfinal ? dfinal + (((size_t)b * H + h) * P + p0) * N : nullptr;
  for (int i = threadIdx.x; i < kPB * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    dS[p * ldS + n] = (df && p < pw) ? df[(size_t)p * N + n] : 0.0f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const size_t row0 = (size_t)b * Tlen + (size_t)c * L;
    for (int i = threadIdx.x; i < L * kPB; i += kThreads) {
      const int t = i / kPB, p = i - t * kPB;
      dys[i] = p < pw ? ld(dy + ((row0 + t) * H + h) * P + p0 + p) : 0.0f;
    }
    load_lcum(lcum, loga, row0, H, h, L);
    const float ltot = lcum[L - 1];
    const float etot = expf(ltot);
    for (int t = threadIdx.x; t < L; t += kThreads) {
      el[t] = expf(lcum[t]);
      wout[t] = expf(ltot - lcum[t]);
    }
    const float* g = G + ((size_t)b * nc + c) * L * L;
    for (int i = threadIdx.x; i < L * L; i += kThreads) {
      const int t = i / L, s = i - t * L;
      W[i] = s <= t ? expf(lcum[t] - lcum[s]) * g[i] : 0.0f;
    }
    __syncthreads();
    // dx, intra-chunk: sum_{t >= s} W[t,s] dy_t
    float fx[kRT], fac[kRT];
#pragma unroll
    for (int k = 0; k < kRT; ++k) {
      const int s = ts + 16 * k;
      float acc = 0.0f;
      if (s < L)
        for (int t = s; t < L; ++t) acc = __fmaf_rn(W[t * L + s], dys[t * kPB + tp], acc);
      fx[k] = acc;
      fac[k] = 0.0f;
    }
    float* dsc = dstates + ((((size_t)b * nc + c) * H + h) * P + p0) * N;
    for (int n0 = 0; n0 < N; n0 += kNT) {
      const int nt = min(kNT, N - n0);
      for (int i = threadIdx.x; i < L * kNT; i += kThreads) {
        const int t = i / kNT, n = i - t * kNT;
        const bool ok = n < nt;
        Bs[t * (kNT + 1) + n] = ok ? ld(Bm + (row0 + t) * N + n0 + n) : 0.0f;
        Cs[t * (kNT + 1) + n] = ok ? ld(C + (row0 + t) * N + n0 + n) : 0.0f;
      }
      __syncthreads();
      // dx, the facet term: dS_next B_s (this n-tile), and dS_next itself out
#pragma unroll
      for (int k = 0; k < kRT; ++k) {
        const int s = ts + 16 * k;
        if (s < L) {
          float acc = fac[k];
          for (int n = 0; n < nt; ++n)
            acc = __fmaf_rn(dS[tp * ldS + n0 + n], Bs[s * (kNT + 1) + n], acc);
          fac[k] = acc;
        }
      }
      for (int i = threadIdx.x; i < pw * nt; i += kThreads) {
        const int p = i / nt, n = i - p * nt;
        dsc[(size_t)p * N + n0 + n] = dS[p * ldS + n0 + n];
      }
      __syncthreads();
      // dS_prev = exp(l_L) dS_next + sum_t exp(l_t) dy_t (outer) C_t (this n-tile)
      for (int i = threadIdx.x; i < kPB * nt; i += kThreads) {
        const int p = i / nt, n = i - p * nt;
        float acc = 0.0f;
        for (int t = 0; t < L; ++t)
          acc = __fmaf_rn(el[t] * dys[t * kPB + p], Cs[t * (kNT + 1) + n], acc);
        dS[p * ldS + n0 + n] = __fmaf_rn(etot, dS[p * ldS + n0 + n], acc);
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kRT; ++k) {
      const int s = ts + 16 * k;
      if (s < L && tp < pw)
        st(dx + ((row0 + s) * H + h) * P + p0 + tp, __fmaf_rn(wout[s], fac[k], fx[k]));
    }
    __syncthreads();
  }
}

// 3. Per chunk, over the heads in order: D = dy x^T (register tiles over
// p-tiles), E = [s<=t] exp(l_t - l_s) D, dG += E, and the head's
// intra-chunk dl from A = G o E; dG replaces G in the scratch at the end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dgram_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ loga,
             float* __restrict__ G, float* __restrict__ dl, int Tlen, int H, int P, int L) {
  extern __shared__ float sm[];
  float* Gs = sm;                     // [L][L]
  float* xs = Gs + L * L;             // [L][kPT + 1]
  float* dys = xs + L * (kPT + 1);    // [L][kPT + 1]
  float* lc = dys + L * (kPT + 1);    // [L]
  float* rrow = lc + L;               // [16][L] row partials of A
  float* rcol = rrow + 16 * L;        // [16][L] column partials of A
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row0 = (size_t)b * Tlen + (size_t)c * L;
  float* g = G + ((size_t)b * nc + c) * L * L;
  for (int i = threadIdx.x; i < L * L; i += kThreads) Gs[i] = g[i];
  float dG[kRT][kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < kRT; ++j) dG[i][j] = 0.0f;
  for (int h = 0; h < H; ++h) {
    load_lcum(lc, loga, row0, H, h, L);
    float D[kRT][kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kRT; ++j) D[i][j] = 0.0f;
    for (int q0 = 0; q0 < P; q0 += kPT) {
      const int pt = min(kPT, P - q0);
      for (int i = threadIdx.x; i < L * kPT; i += kThreads) {
        const int t = i / kPT, p = i - t * kPT;
        const bool ok = p < pt;
        const size_t off = ((row0 + t) * H + h) * P + q0 + p;
        xs[t * (kPT + 1) + p] = ok ? ld(x + off) : 0.0f;
        dys[t * (kPT + 1) + p] = ok ? ld(dy + off) : 0.0f;
      }
      __syncthreads();
      for (int p = 0; p < pt; ++p) {
        float a[kRT], bb[kRT];
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const int t = ty + 16 * i, s = tx + 16 * i;
          a[i] = t < L ? dys[t * (kPT + 1) + p] : 0.0f;
          bb[i] = s < L ? xs[s * (kPT + 1) + p] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int j = 0; j < kRT; ++j) D[i][j] = __fmaf_rn(a[i], bb[j], D[i][j]);
      }
      __syncthreads();
    }
    float rowp[kRT], colp[kRT];
#pragma unroll
    for (int k = 0; k < kRT; ++k) rowp[k] = colp[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kRT; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        if (t < L && s <= t) {
          const float e = expf(lc[t] - lc[s]) * D[i][j];
          dG[i][j] += e;
          const float a = Gs[t * L + s] * e;
          rowp[i] += a;
          colp[j] += a;
        }
      }
#pragma unroll
    for (int k = 0; k < kRT; ++k) {
      const int t = ty + 16 * k, s = tx + 16 * k;
      if (t < L) rrow[tx * L + t] = rowp[k];
      if (s < L) rcol[ty * L + s] = colp[k];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < L; t += kThreads) {
      float r = 0.0f, cl = 0.0f;
      for (int k = 0; k < 16; ++k) {
        r += rrow[k * L + t];
        cl += rcol[k * L + t];
      }
      dl[(row0 + t) * H + h] = r - cl;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < kRT; ++j) {
      const int t = ty + 16 * i, s = tx + 16 * j;
      if (t < L && s < L) g[t * L + s] = s <= t ? dG[i][j] : 0.0f;
    }
}

// 4. Per chunk and 32-column tile of N, over the heads in order: the
// inter-chunk and facet terms of dC, dB and dl, then dC and dB with dG's
// products; last, dloga = the reverse cumsum of dl inside the chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dbc_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ loga,
           const T* __restrict__ Bm, const T* __restrict__ C, const float* __restrict__ states,
           const float* __restrict__ dstates, const float* __restrict__ dG,
           float* __restrict__ dl, T* __restrict__ dB, T* __restrict__ dC, int Tlen, int H,
           int P, int N, int L) {
  extern __shared__ float sm[];
  constexpr int ldn = kNT3 + 1, ldp = kPT + 1;
  float* dGs = sm;                    // [L][L]
  float* Bs = dGs + L * L;            // [L][ldn]
  float* Cs = Bs + L * ldn;           // [L][ldn]
  float* xs = Cs + L * ldn;           // [L][ldp]
  float* dys = xs + L * ldp;          // [L][ldp]
  float* Ss = dys + L * ldp;          // [kPT][ldn] S_prev tile
  float* dSs = Ss + kPT * ldn;        // [kPT][ldn] dS_next tile
  float* lc = dSs + kPT * ldn;        // [L]
  float* el = lc + L;                 // [L]
  float* wout = el + L;               // [L]
  float* fsum = wout + L;             // [L] facet dl terms of one head
  float* rc = fsum + L;               // [16][L]
  float* rb = rc + 16 * L;            // [16][L]
  float* rsd = rb + 16 * L;           // [kThreads] <dS_next, S_prev> partials
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row0 = (size_t)b * Tlen + (size_t)c * L;
  const float* g = dG + ((size_t)b * nc + c) * L * L;
  for (int i = threadIdx.x; i < L * L; i += kThreads) dGs[i] = g[i];

  for (int n0 = 0; n0 < N; n0 += kNT3) {
    const int nt = min(kNT3, N - n0);
    for (int i = threadIdx.x; i < L * kNT3; i += kThreads) {
      const int t = i / kNT3, n = i - t * kNT3;
      const bool ok = n < nt;
      Bs[t * ldn + n] = ok ? ld(Bm + (row0 + t) * N + n0 + n) : 0.0f;
      Cs[t * ldn + n] = ok ? ld(C + (row0 + t) * N + n0 + n) : 0.0f;
    }
    float accC[kRT][2], accB[kRT][2];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) accC[i][j] = accB[i][j] = 0.0f;
    for (int h = 0; h < H; ++h) {
      load_lcum(lc, loga, row0, H, h, L);  // (its barriers also cover the staging above)
      const float ltot = lc[L - 1];
      const float etot = expf(ltot);
      for (int t = threadIdx.x; t < L; t += kThreads) {
        el[t] = expf(lc[t]);
        wout[t] = expf(ltot - lc[t]);
      }
      float R[kRT][2], U[kRT][2];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) R[i][j] = U[i][j] = 0.0f;
      float sd = 0.0f;
      const size_t sbase = (((size_t)b * nc + c) * H + h) * P * N;
      for (int q0 = 0; q0 < P; q0 += kPT) {
        const int pt = min(kPT, P - q0);
        for (int i = threadIdx.x; i < L * kPT; i += kThreads) {
          const int t = i / kPT, p = i - t * kPT;
          const bool ok = p < pt;
          const size_t off = ((row0 + t) * H + h) * P + q0 + p;
          xs[t * ldp + p] = ok ? ld(x + off) : 0.0f;
          dys[t * ldp + p] = ok ? ld(dy + off) : 0.0f;
        }
        for (int i = threadIdx.x; i < kPT * kNT3; i += kThreads) {
          const int p = i / kNT3, n = i - p * kNT3;
          const bool ok = p < pt && n < nt;
          const size_t off = sbase + (size_t)(q0 + p) * N + n0 + n;
          Ss[p * ldn + n] = ok ? states[off] : 0.0f;
          dSs[p * ldn + n] = ok ? dstates[off] : 0.0f;
        }
        __syncthreads();
        for (int p = 0; p < pt; ++p) {
          float a[kRT], u[kRT], sv[2], dv[2];
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            const int t = ty + 16 * i;
            a[i] = t < L ? dys[t * ldp + p] : 0.0f;
            u[i] = t < L ? xs[t * ldp + p] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sv[j] = Ss[p * ldn + tx + 16 * j];
            dv[j] = dSs[p * ldn + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < kRT; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              R[i][j] = __fmaf_rn(a[i], sv[j], R[i][j]);
              U[i][j] = __fmaf_rn(u[i], dv[j], U[i][j]);
            }
        }
        for (int i = threadIdx.x; i < kPT * kNT3; i += kThreads) {
          const int p = i / kNT3, n = i - p * kNT3;
          sd = __fmaf_rn(dSs[p * ldn + n], Ss[p * ldn + n], sd);
        }
        __syncthreads();
      }
      float rowc[kRT], rowb[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = ty + 16 * i;
        rowc[i] = rowb[i] = 0.0f;
        if (t < L) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = tx + 16 * j;
            const float r = el[t] * R[i][j], u = wout[t] * U[i][j];
            accC[i][j] += r;
            accB[i][j] += u;
            rowc[i] = __fmaf_rn(Cs[t * ldn + n], r, rowc[i]);
            rowb[i] = __fmaf_rn(Bs[t * ldn + n], u, rowb[i]);
          }
          rc[tx * L + t] = rowc[i];
          rb[tx * L + t] = rowb[i];
        }
      }
      rsd[threadIdx.x] = sd;
      __syncthreads();
      for (int t = threadIdx.x; t < L; t += kThreads) {
        float ic = 0.0f, fb = 0.0f;
        for (int k = 0; k < 16; ++k) {
          ic += rc[k * L + t];
          fb += rb[k * L + t];
        }
        fsum[t] = fb;
        dl[(row0 + t) * H + h] += ic - fb;
      }
      __syncthreads();
      if (threadIdx.x < 32) {  // the last step's terms: strided lane sums, then a fixed tree
        float s2 = 0.0f, f = 0.0f;
        for (int k = threadIdx.x; k < kThreads; k += 32) s2 += rsd[k];
        for (int t = threadIdx.x; t < L; t += 32) f += fsum[t];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
          f += __shfl_xor_sync(0xffffffffu, f, off);
        }
        if (threadIdx.x == 0) dl[(row0 + L - 1) * H + h] += __fmaf_rn(etot, s2, f);
      }
      __syncthreads();
    }
    // dC_t = sum_s dG[t,s] B_s + accC; dB_s = sum_t dG[t,s] C_t + accB (each
    // sum in ascending order, the thread's 16 of each side by side)
    float sc[kRT][2], sb[kRT][2];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[i][j] = sb[i][j] = 0.0f;
    for (int u = 0; u < L; ++u) {
      const float b0 = Bs[u * ldn + tx], b1 = Bs[u * ldn + tx + 16];
      const float c0 = Cs[u * ldn + tx], c1 = Cs[u * ldn + tx + 16];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = ty + 16 * i;
        if (t < L && u <= t) {  // dC row t: s = u
          const float gc = dGs[t * L + u];
          sc[i][0] = __fmaf_rn(gc, b0, sc[i][0]);
          sc[i][1] = __fmaf_rn(gc, b1, sc[i][1]);
        }
        if (t < L && u >= t) {  // dB row t: the dG column t at row u
          const float gb = dGs[u * L + t];
          sb[i][0] = __fmaf_rn(gb, c0, sb[i][0]);
          sb[i][1] = __fmaf_rn(gb, c1, sb[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = tx + 16 * j;
        if (t < L && n < nt) {
          st(dC + (row0 + t) * N + n0 + n, sc[i][j] + accC[i][j]);
          st(dB + (row0 + t) * N + n0 + n, sb[i][j] + accB[i][j]);
        }
      }
    }
    __syncthreads();
  }
  // dloga_s = sum_{t >= s} dl_t inside the chunk
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float acc = 0.0f;
    for (int t = L - 1; t >= 0; --t) {
      acc += dl[(row0 + t) * H + h];
      dl[(row0 + t) * H + h] = acc;
    }
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch(const T* x, const float* loga, const T* Bm, const T* C, const float* states,
           const T* dy, const float* dfinal, T* dx, float* dloga, T* dB, T* dC, float* gram,
           float* dstates, int Bsz, int Tlen, int H, int P, int N, int L, cudaStream_t st) {
  const int nc = Tlen / L;
  const size_t s1 = 4 * gram_floats(L), s2 = 4 * dstate_floats(N, L),
               s3 = 4 * dgram_floats(L), s4 = 4 * dbc_floats(L);
  if (s1 > kMaxSmem || s2 > kMaxSmem || s3 > kMaxSmem || s4 > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = set_smem((const void*)gram_kernel<T>, s1)) != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)dstate_kernel<T>, s2)) != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)dgram_kernel<T>, s3)) != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)dbc_kernel<T>, s4)) != cudaSuccess) return (int)err;
  const dim3 gchunk(nc, Bsz);
  gram_kernel<T><<<gchunk, kThreads, s1, st>>>(Bm, C, gram, Tlen, N, L);
  dstate_kernel<T><<<dim3((P + kPB - 1) / kPB, H, Bsz), kThreads, s2, st>>>(
      dy, loga, Bm, C, gram, dfinal, dstates, dx, Tlen, H, P, N, L);
  dgram_kernel<T><<<gchunk, kThreads, s3, st>>>(x, dy, loga, gram, dloga, Tlen, H, P, L);
  dbc_kernel<T><<<gchunk, kThreads, s4, st>>>(x, dy, loga, Bm, C, states, dstates, gram, dloga,
                                             dB, dC, Tlen, H, P, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one CTA of launch `which` (0 gram, 1 dstate, 2 dgram,
// 3 dbc), in bytes; the wrapper's backward_plan mirrors it.
extern "C" long ssd_scan_bwd_smem(int which, int N, int L) {
  switch (which) {
    case 0: return (long)(4 * gram_floats(L));
    case 1: return (long)(4 * dstate_floats(N, L));
    case 2: return (long)(4 * dgram_floats(L));
    case 3: return (long)(4 * dbc_floats(L));
    default: return 0;
  }
}

// dtype code (x, B, C, dy, dx, dB and dC): 0 = float32, 1 = bfloat16; loga,
// the saved states (B, nc, H, P, N), the final state's gradient (B, H, P, N;
// null for zero), dloga and the scratch (gram (B, nc, L, L), dstates like
// the states) are float32.  Returns a cudaError_t (0 = success); 1
// (cudaErrorInvalidValue) for shapes the kernels do not take.
extern "C" int ssd_scan_bwd(int dtype, const void* x, const float* loga, const void* Bm,
                            const void* C, const float* states, const void* dy,
                            const float* dfinal, void* dx, float* dloga, void* dB, void* dC,
                            float* gram, float* dstates, int Bsz, int Tlen, int H, int P, int N,
                            int L, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || H <= 0 || H > 65535 || P <= 0 || N <= 0 || N > kMaxN ||
      L <= 0 || L > kMaxChunk || Tlen <= 0 || Tlen % L != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(static_cast<const float*>(x), loga, static_cast<const float*>(Bm),
                         static_cast<const float*>(C), states, static_cast<const float*>(dy),
                         dfinal, static_cast<float*>(dx), dloga, static_cast<float*>(dB),
                         static_cast<float*>(dC), gram, dstates, Bsz, Tlen, H, P, N, L, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), loga, static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(C), states, static_cast<const __nv_bfloat16*>(dy),
        dfinal, static_cast<__nv_bfloat16*>(dx), dloga, static_cast<__nv_bfloat16*>(dB),
        static_cast<__nv_bfloat16*>(dC), gram, dstates, Bsz, Tlen, H, P, N, L, st);
  return (int)cudaErrorInvalidValue;
}
