// Facet-layout decode attention for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces: src/repro/kernels/block_attention/block_attention.py::decode_attention
// (the Pallas kernel `_kernel`).  One GQA decode step: for every batch row b
// and query head h, softmax(q . K^T / sqrt(D)) . V over the valid prefix
// pos < lengths[b] of a block-layout KV cache (B, nb, Hkv, bs, D), whose
// (bs, D) extents are the contiguous bursts of the CFA layout.
//
// What bounds it: memory.  Each cached K/V element is read once and used for
// G = Hq/Hkv query heads (G = 2 for qwen3), about one flop per byte, far
// below the card's ~20 f32 flops per byte: the least time is the valid K/V
// prefix plus q and out over 3.35 TB/s.  At qwen3's decode tick (B 8, Hkv 8,
// ~710 valid keys per row) that is ~23 MB, ~7 us: the kernel has to keep
// every SM's memory pipe busy, and one CTA per (kv head, row) walking its
// prefix in series (64 CTAs for 132 SMs, every tile paying the full load
// latency) cannot.
//
// Design:
// * split-K along the cache's own facet blocks: the grid is (split, kv head,
//   row).  A split is a fixed range of kSplit = 128 positions inside one
//   block (the whole block when bs <= 128), so the grid follows from the
//   static shape nb*bs alone and the host never reads `lengths` (no sync;
//   the call can be captured in a CUDA graph).  A CTA whose range starts at
//   or past lengths[b] exits at once; at qwen3's tick ~380 of 1024 CTAs
//   work, about three per SM;
// * one bulk copy per burst: rows [r, r+n) of block (b, blk, h) are one
//   contiguous extent of n*D*esize bytes (16 KiB for 64 bf16 rows at D 128).
//   Thread 0 issues one cp.async.bulk for K and one for V per sub-tile of
//   `sub` rows into a ring of kStages = 2 shared-memory stages completed on
//   mbarriers, and refills a stage as soon as the CTA has consumed it, so
//   the next sub-tile is in flight while this one computes.  Only rows below
//   the length are copied, so the bytes read are the bound's bytes.  K/V
//   stay in their stored type in shared memory.  `sub` keeps a stage at
//   <= 32 KiB (64 rows of 256 B, 32 of 512 B, 16 of 1 KiB), so a CTA needs
//   <= 64 KiB of ring plus its G*D accumulators: at qwen3's shape ~67 KiB,
//   three CTAs per SM.  A shape whose row is not a multiple of 16 bytes, or
//   a K/V pointer that is not 16-byte aligned, takes word loads by all
//   threads inside the same kernel instead (never the plain version);
// * products on f32 CUDA cores: scores one warp per key (lanes split D, one
//   shuffle reduction per query head; for up to 4 heads two keys per warp
//   at once, the heads' partials in registers, so each K element is read
//   once for all heads and the independent shuffle chains hide each
//   other's latency), online softmax per head with f32
//   running max m and denominator l and the Pallas kernel's guard (a fully
//   masked range leaves alpha = 1, p = 0), acc = acc * alpha + p . V with
//   each thread owning fixed (g, d) entries.  At G = 2 tensor cores would
//   not help: bytes bound it;
// * one launch per call, with an in-kernel combine: each working split
//   writes its f32 partial (m, l, acc[G][D]) to a workspace, fences, and
//   takes a ticket from an atomic counter per (row, kv head).  The last CTA
//   merges the partials in split order (the same result on every run):
//   each split's weight exp(m_s - max m) is computed once per head into
//   the ring (sized for it) from loads made in parallel, so no thread walks
//   the partials' maxima through L2 in series.  It divides, rounds once to q's
//   type and resets the ticket for the next call.  A row with one working
//   split writes its output directly;
// * exact expf and IEEE division (no fast math), f32 accumulation with
//   explicit fused multiply-adds: only the order of the sums differs from
//   the plain version;
// * `lengths` is read as int32 or int64 with a stride, so the model's
//   broadcast int64 positions need no cast or copy launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kMaxD = 256;
constexpr int kMaxSub = 64;
constexpr int kMaxPerLane = kMaxD / 32;
constexpr int kRegG = 4;  // at most this many heads' scores are kept in registers
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// -- mbarrier and bulk-copy primitives (PTX, sm_90) --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// order the CTA's generic-proxy reads of a stage before the bulk copy that refills it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// the K/V ring, which the combine reuses for (nsplit + 1) * G floats
__host__ __device__ inline size_t ring_size(int G, int D, int sub, int kv_esize, int nsplit) {
  const size_t ring = 2 * kStages * round16((size_t)sub * D * kv_esize);
  const size_t combine = round16(sizeof(float) * ((size_t)nsplit + 1) * G);
  return ring > combine ? ring : combine;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* lengths;
  long long len_stride;
  void* out;
  float* part;          // [B][Hkv][nsplit][G][D + 2]: m[G], l[G], acc[G][D]
  unsigned* tickets;    // [B * Hkv], 0 between calls
  int Hq, Hkv, nb, bs, D;
  int split;            // positions per split (<= bs)
  int nspb;             // splits per block
  int nsplit;           // nb * nspb
  int sub;              // rows per staged sub-tile
  int bulk;             // 1: cp.async.bulk, 0: word loads
};

// Scores of a sub-tile's n keys for G <= NG query heads, one warp per key and
// two keys per warp at once: each K element is read once for all heads, and
// the 2 * NG shuffle reductions are independent, so their latencies overlap.
template <int NG, typename KT>
__device__ __forceinline__ void scores_in_registers(const float* qs, const KT* ks, float* sc,
                                                    int n, int G, int D, int sub, float scale,
                                                    int warp, int lane) {
  for (int j0 = warp; j0 < n; j0 += 2 * kWarps) {
    const int j1 = j0 + kWarps;
    const KT* kr0 = ks + (size_t)j0 * D;
    const KT* kr1 = ks + (size_t)min(j1, n - 1) * D;
    float part[2][NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) part[0][g] = part[1][g] = 0.0f;
#pragma unroll
    for (int u = 0; u < kMaxPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < D) {
        const float k0 = to_f(kr0[d]), k1 = to_f(kr1[d]);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (g < G) {
            part[0][g] = __fmaf_rn(qs[g * D + d], k0, part[0][g]);
            part[1][g] = __fmaf_rn(qs[g * D + d], k1, part[1][g]);
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        part[0][g] += __shfl_xor_sync(0xffffffffu, part[0][g], off);
        part[1][g] += __shfl_xor_sync(0xffffffffu, part[1][g], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {  // unrolled: `part` stays in registers
        if (g < G) {
          sc[g * sub + j0] = part[0][g] / scale;
          if (j1 < n) sc[g * sub + j1] = part[1][g] / scale;
        }
      }
    }
  }
}

template <typename QT, typename KT, typename LT>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ int is_last;

  const int s = blockIdx.x;   // split
  const int h = blockIdx.y;   // kv head
  const int b = blockIdx.z;   // batch row
  const int D = a.D, G = a.Hq / a.Hkv, sub = a.sub;
  const int cap = a.nb * a.bs;
  long long len = static_cast<const LT*>(a.lengths)[(long long)b * a.len_stride];
  const int L = (int)(len < 0 ? 0 : (len > cap ? cap : len));
  // the splits that start below L, in order (split 0 always: an empty row
  // still writes its 0/0 like the plain version)
  const int n_work = max(1, (L / a.bs) * a.nspb + (L % a.bs + a.split - 1) / a.split);
  if (s >= n_work) return;
  const int blk = s / a.nspb, r0 = (s % a.nspb) * a.split;
  const int start = blk * a.bs + r0;
  const int n_valid = max(0, min(min(a.split, a.bs - r0), L - start));
  const int nsub = (n_valid + sub - 1) / sub;

  const size_t stage_bytes = round16((size_t)sub * D * sizeof(KT));
  const size_t ring_bytes = ring_size(G, D, sub, sizeof(KT), a.nsplit);
  KT* kbuf[kStages];
  KT* vbuf[kStages];
  for (int st = 0; st < kStages; ++st) {
    kbuf[st] = reinterpret_cast<KT*>(smem + (2 * st) * stage_bytes);
    vbuf[st] = reinterpret_cast<KT*>(smem + (2 * st + 1) * stage_bytes);
  }
  float* qs = reinterpret_cast<float*>(smem + ring_bytes);  // [G][D]
  float* acc = qs + G * D;        // [G][D] running numerators
  float* sc = acc + G * D;        // [G][sub] scores, then probabilities
  float* m = sc + G * sub;        // [G] running max
  float* l = m + G;               // [G] running denominator
  float* alpha = l + G;           // [G] this sub-tile's rescale factor

  const size_t row0 = (((size_t)b * a.nb + blk) * a.Hkv + h) * a.bs + r0;
  const KT* kg = static_cast<const KT*>(a.k) + row0 * D;
  const KT* vg = static_cast<const KT*>(a.v) + row0 * D;
  const int tid = threadIdx.x;

  auto issue = [&](int i) {  // thread 0: sub-tile i into stage i % kStages
    const int st = i % kStages;
    const int n = min(sub, n_valid - i * sub);
    const uint32_t bytes = (uint32_t)((size_t)n * D * sizeof(KT));
    mbar_arrive_expect_tx(&bars[st], 2 * bytes);
    bulk_copy(kbuf[st], kg + (size_t)i * sub * D, bytes, &bars[st]);
    bulk_copy(vbuf[st], vg + (size_t)i * sub * D, bytes, &bars[st]);
  };
  if (tid == 0 && a.bulk) {
    for (int st = 0; st < kStages; ++st) mbar_init(&bars[st], 1);
    mbar_fence_init();
    for (int i = 0; i < min(kStages, nsub); ++i) issue(i);
  }

  const QT* qb = static_cast<const QT*>(a.q) + ((size_t)b * a.Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
  }
  const float scale = sqrtf((float)D);
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int i = 0; i < nsub; ++i) {
    const int st = i % kStages;
    const int n = min(sub, n_valid - i * sub);
    const KT* ks = kbuf[st];
    const KT* vs = vbuf[st];
    if (a.bulk) {
      mbar_wait(&bars[st], (uint32_t)((i / kStages) & 1));
    } else {
      const KT* ksrc = kg + (size_t)i * sub * D;
      const KT* vsrc = vg + (size_t)i * sub * D;
      for (int e = tid; e < n * D; e += kThreads) {
        kbuf[st][e] = ksrc[e];
        vbuf[st][e] = vsrc[e];
      }
      __syncthreads();
    }
    // 1. scores of this sub-tile's keys, one warp per key
    if (G == 1) {
      scores_in_registers<1>(qs, ks, sc, n, G, D, sub, scale, warp, lane);
    } else if (G == 2) {
      scores_in_registers<2>(qs, ks, sc, n, G, D, sub, scale, warp, lane);
    } else if (G <= kRegG) {
      scores_in_registers<kRegG>(qs, ks, sc, n, G, D, sub, scale, warp, lane);
    } else {
      for (int j = warp; j < n; j += kWarps) {
        const KT* kr = ks + (size_t)j * D;
        for (int g = 0; g < G; ++g) {
          float part = 0.0f;
#pragma unroll
          for (int u = 0; u < kMaxPerLane; ++u) {
            const int d = lane + 32 * u;
            if (d < D) part = __fmaf_rn(qs[g * D + d], to_f(kr[d]), part);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
          if (lane == 0) sc[g * sub + j] = part / scale;
        }
      }
    }
    __syncthreads();
    // 2. online softmax per query head, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* sg = sc + g * sub;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sg[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      const bool finite = isfinite(m_new);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float p = finite ? expf(sg[j] - m_new) : 0.0f;
        sg[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float al = finite ? expf(m_prev - m_new) : 1.0f;
        alpha[g] = al;
        m[g] = m_new;
        l[g] = l[g] * al + sum;
      }
    }
    __syncthreads();
    // 3. acc = acc * alpha + p . V, each thread owning fixed (g, d) entries
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      const float* pg = sc + g * sub;
      float s_acc = 0.0f;
      for (int j = 0; j < n; ++j) s_acc = __fmaf_rn(pg[j], to_f(vs[(size_t)j * D + d]), s_acc);
      acc[e] = acc[e] * alpha[g] + s_acc;
    }
    __syncthreads();
    if (a.bulk && tid == 0 && i + kStages < nsub) {
      fence_proxy_async();
      issue(i + kStages);
    }
  }

  QT* ob = static_cast<QT*>(a.out) + ((size_t)b * a.Hq + (size_t)h * G) * D;
  if (n_work == 1) {  // the row's only split: no combine
    for (int e = tid; e < G * D; e += kThreads) ob[e] = from_f<QT>(acc[e] / l[e / D]);
    return;
  }
  const size_t pstride = (size_t)G * (D + 2);
  float* rowpart = a.part + ((size_t)b * a.Hkv + h) * a.nsplit * pstride;
  float* mine = rowpart + (size_t)s * pstride;
  for (int g = tid; g < G; g += kThreads) {
    mine[g] = m[g];
    mine[G + g] = l[g];
  }
  for (int e = tid; e < G * D; e += kThreads) mine[2 * G + e] = acc[e];
  __threadfence();
  __syncthreads();
  unsigned* ticket = a.tickets + (size_t)b * a.Hkv + h;
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == (unsigned)(n_work - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the combine, in split order: each split's weight w = exp(m_s - max m)
  // per head, computed once into the ring (free now; sized for it)
  float* wl = reinterpret_cast<float*>(smem);  // [n_work][G] weights
  float* red = wl + (size_t)n_work * G;        // [G] max m, then the sum of w l
  for (int i = tid; i < n_work * G; i += kThreads)
    wl[i] = __ldcg(rowpart + (size_t)(i / G) * pstride + i % G);  // every m_s, in parallel
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float mx = -INFINITY;
    for (int j = 0; j < n_work; ++j) mx = fmaxf(mx, wl[j * G + g]);
    red[g] = mx;
  }
  __syncthreads();
  for (int i = tid; i < n_work * G; i += kThreads) {
    const float mx = red[i % G];
    wl[i] = isfinite(mx) ? expf(wl[i] - mx) : 0.0f;
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float lsum = 0.0f;
    for (int j = 0; j < n_work; ++j)
      lsum = __fmaf_rn(wl[j * G + g], __ldcg(rowpart + (size_t)j * pstride + G + g), lsum);
    red[g] = lsum;
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    float num = 0.0f;
#pragma unroll 4
    for (int j = 0; j < n_work; ++j)
      num = __fmaf_rn(wl[j * G + g], __ldcg(rowpart + (size_t)j * pstride + 2 * G + e), num);
    ob[e] = from_f<QT>(num / red[g]);
  }
  if (tid == 0) *ticket = 0u;  // ready for the next call
}

size_t smem_bytes(int G, int D, int sub, int kv_esize, int nsplit) {
  return ring_size(G, D, sub, kv_esize, nsplit) +
         sizeof(float) * ((size_t)2 * G * D + (size_t)G * sub + 3 * (size_t)G);
}

template <typename QT, typename KT, typename LT>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<QT, KT, LT>;
  // raised once per instantiation and size (not per call: a captured call
  // makes no attribute call once its shape has run eagerly)
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  kernel<<<dim3(a.nsplit, a.Hkv, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_len(int len_dtype, const Args& a, int B, size_t smem, cudaStream_t st) {
  return len_dtype == 0 ? launch<QT, KT, int>(a, B, smem, st)
                        : launch<QT, KT, long long>(a, B, smem, st);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; len_dtype: 0 = int32, 1 = int64.
// `part` holds B*Hkv*nb*ceil(bs/split)*(Hq/Hkv)*(D+2) floats (any contents),
// `tickets` B*Hkv uint32 zeros (left zero).  Returns a cudaError_t (0 =
// launched); 1 (cudaErrorInvalidValue) for arguments the kernel does not take.
extern "C" int decode_attention(int q_dtype, int kv_dtype, int len_dtype, const void* q,
                                const void* k, const void* v, const void* lengths,
                                long long len_stride, void* out, void* part, void* tickets,
                                int B, int Hq, int Hkv, int nb, int bs, int D, int split,
                                int sub, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxD || nb <= 0 || bs <= 0 || split <= 0 || split > bs || sub <= 0 ||
      sub > kMaxSub || (len_dtype != 0 && len_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int kv_esize = kv_dtype == 0 ? 4 : 2;
  const int nspb = (bs + split - 1) / split;
  if ((long long)nb * nspb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Hq / Hkv, D, sub, kv_esize, nb * nspb);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = lengths;
  a.len_stride = len_stride;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned*>(tickets);
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.nb = nb;
  a.bs = bs;
  a.D = D;
  a.split = split;
  a.nspb = nspb;
  a.nsplit = nb * nspb;
  a.sub = sub;
  a.bulk = ((size_t)D * kv_esize) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch_len<float, float>(len_dtype, a, B, smem, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch_len<__nv_bfloat16, __nv_bfloat16>(len_dtype, a, B, smem, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch_len<float, __nv_bfloat16>(len_dtype, a, B, smem, st);
  return (int)cudaErrorInvalidValue;
}
