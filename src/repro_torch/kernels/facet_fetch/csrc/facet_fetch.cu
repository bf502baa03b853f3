// CFA read engine for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces: src/repro/kernels/facet_fetch/facet_fetch.py::fetch_interior_halos
// (the Pallas kernels `_kernel` and `_kernel_irredundant`).  For every
// interior tile (q0, q1, q2) = (i+1, j+1, k+1) of a 3-D CFA facet family it
// assembles the tile's (w0+t0, w1+t1, w2+t2) halo buffer from the facet
// arrays and writes it to out[i, j, k]; the interior [w0:, w1:, w2:] is 0.
//
// What bounds it: memory.  It is pure data movement — no arithmetic — so the
// least time is the distinct facet bytes it reads plus the halo bytes it
// writes over the card's 3.35 TB/s.  Read element by element, a facet's
// inner order ((t1,t2,w0), (t2,t0,w1), (t0,t1,w2)) runs across the output's
// (x0,x1,x2) order: every load is a scattered 4- or 8-byte gather.
//
// Design: the JAX kernel's own plan — each facet block one contiguous
// extent, one DMA — on Hopper's bulk-copy engine.
// * one CTA per interior tile; its addressing takes the place of the
//   BlockSpec index maps: each burst's 64-bit base is computed once per CTA
//   from (q0, q1, q2) and per-burst constants the host derives from the
//   facet arrays' shapes (base + q . stride), never per element;
// * the bursts ("slots"): the blocks a tile needs, with the pairs that are
//   adjacent in the facet array merged as in the paper (facet_0's blocks of
//   tiles q1-1 and q1 are neighbours along its last outer axis, facet_1's
//   of q2-1 and q2 along its own), and only the used tail of the first
//   block of a pair copied.  Redundant storage: 4 bursts (facet_0 at
//   (q0-1, ., q2) and (q0-1, ., q2-1), facet_1 at (q0, q1-1, .), facet_2 at
//   (q0, q1, q2-1)); irredundant adds 3 owner bursts (facet_0 at (q0, q1-1,
//   q2) and (q0, ., q2-1), facet_1 at (q0, q1, q2-1)): 7;
// * staging: thread 0 issues one cp.async.bulk per burst into shared
//   memory, all completing on one mbarrier; a burst whose address or size
//   is not a multiple of 16 bytes is copied by all threads with word loads
//   instead (same kernel, same staging).  Only the copied part of a slot is
//   allocated: at the cut jacobi2d5p cell (tile (16, 256, 2), w (1, 2, 2))
//   a tile stages 39 744 B in float32, five CTAs per SM, each CTA's copies
//   in flight while the others assemble.  A tile whose bursts
//   exceed shared memory reads them in place from device memory (the same
//   addressing, no staging);
// * assembly from shared memory by the owner rule: an axis a is "halo"
//   when x_a < w_a (tile q_a - 1's tail slab) and "in-slab" when x_a >= t_a.
//   Redundant storage reads the facet of the lowest halo axis, irredundant
//   the lowest halo-or-in-slab axis (the value's owner); points with no
//   halo axis are the tile interior and read as 0.  Within the owner's
//   block the modulo coordinate is x_k mod w_k and every other axis's
//   coordinate is x_a - w_a (+ t_a when halo);
// * the tile's contiguous (h0, h1, h2) extent of `out` is written with
//   16-byte stores (4 float32 or 2 float64 per store: one x2-row at the cut
//   cell), the interior's zeros included, when h2 is a multiple of that
//   and `out` is 16-byte aligned; else with word stores;
// * bit copies: elements move as 4- or 8-byte words (uint32_t / uint64_t),
//   so the result is bit-exact for float32 and float64 by construction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 7;
constexpr size_t kMaxSmem = 232448 - 1024;  // dynamic shared memory left beside the statics

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

// Slot order (the host's `burst_plan` builds them in this order):
//   0 facet_0, tiles (q0-1, q1-1|q1, q2)    1 facet_0, (q0-1, q1-1|q1, q2-1)
//   2 facet_1, (q0, q1-1, q2-1|q2)          3 facet_2, (q0, q1, q2-1)
//   irredundant: 4 facet_0, (q0, q1-1, q2)  5 facet_0, (q0, q1-1|q1, q2-1)
//                6 facet_1, (q0, q1, q2-1)
// A slot's pointer addresses its first block's start; a pair's second block
// follows it at one block size.
struct Params {
  int g[3], w[3], t[3], h[3];
  int irredundant;
  int n_slots;
  int smem;                     // staged bytes (0: read in place)
  int vec;                      // 16-byte output stores
  int facet[kMaxSlots];
  int off[kMaxSlots];           // the burst's byte offset in shared memory
  int64_t c[kMaxSlots];         // first block's start at q = 0
  int64_t s[kMaxSlots][3];      // ... and its element stride per unit of q_a
  int64_t start[kMaxSlots];     // burst start within the slot (elements)
  int64_t len[kMaxSlots];       // burst length (elements)
};

template <typename W>
__global__ void __launch_bounds__(kThreads)
facet_fetch_kernel(const W* __restrict__ f0, const W* __restrict__ f1,
                   const W* __restrict__ f2, W* __restrict__ out, Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ const W* slot[kMaxSlots];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int k = tile % p.g[2];
  const int rest = tile / p.g[2];
  const int j = rest % p.g[1];
  const int i = rest / p.g[1];
  const int64_t q[3] = {i + 1, j + 1, k + 1};
  const W* facet[3] = {f0, f1, f2};
  const bool staged = p.smem > 0;

  // 1. the bursts: bulk copies by thread 0, word copies by all threads
  if (staged && tid == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
    uint32_t tx = 0;
    for (int s = 0; s < p.n_slots; ++s) {
      const W* src = facet[p.facet[s]] + p.c[s] + q[0] * p.s[s][0] + q[1] * p.s[s][1] +
                     q[2] * p.s[s][2] + p.start[s];
      const size_t bytes = (size_t)p.len[s] * sizeof(W);
      if ((reinterpret_cast<uintptr_t>(src) | bytes) % 16 == 0) tx += (uint32_t)bytes;
    }
    mbar_arrive_expect_tx(&bar, tx);
  }
  for (int s = 0; s < p.n_slots; ++s) {
    const W* base = facet[p.facet[s]] + p.c[s] + q[0] * p.s[s][0] + q[1] * p.s[s][1] +
                    q[2] * p.s[s][2];
    if (!staged) {
      if (tid == 0) slot[s] = base;
      continue;
    }
    W* dst = reinterpret_cast<W*>(smem + p.off[s]);
    const W* src = base + p.start[s];
    const size_t bytes = (size_t)p.len[s] * sizeof(W);
    if (tid == 0) slot[s] = dst - p.start[s];
    if ((reinterpret_cast<uintptr_t>(src) | bytes) % 16 == 0) {
      if (tid == 0) bulk_copy(dst, src, (uint32_t)bytes, &bar);
    } else {
      for (int64_t e = tid; e < p.len[s]; e += kThreads) dst[e] = src[e];
    }
  }
  __syncthreads();
  if (staged) mbar_wait(&bar, 0);

  // 2. the tile's halo buffer, V words per item, by the owner rule
  constexpr int V = 16 / sizeof(W);
  const int w0 = p.w[0], w1 = p.w[1], w2 = p.w[2];
  const int t0 = p.t[0], t1 = p.t[1], t2 = p.t[2];
  const int h1 = p.h[1], h2 = p.h[2];
  const int B0 = t1 * t2 * w0, B1 = t2 * t0 * w1;
  const int nch = (h2 + V - 1) / V;
  const int items = p.h[0] * h1 * nch;
  W* dst = out + (size_t)tile * p.h[0] * h1 * h2;
  for (int it = tid; it < items; it += kThreads) {
    const int r = it / nch, c = it - r * nch;
    const int x0 = r / h1, x1 = r - x0 * h1;
    const bool halo0 = x0 < w0, halo1 = x1 < w1;
    const bool own0 = halo0 || (p.irredundant && x0 >= t0);
    const bool own1 = halo1 || (p.irredundant && x1 >= t1);
    union {
      W w[V];
      uint4 u;
    } pack;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int x2 = c * V + e;
      W v = 0;  // the tile interior (and the row's padding past h2)
      const bool halo2 = x2 < w2;
      if (x2 < h2 && (halo0 || halo1 || halo2)) {
        const int i2 = x2 - w2 + (halo2 ? t2 : 0);
        if (own0) {
          const W* sp = slot[halo0 ? (halo2 ? 1 : 0) : (halo2 ? 5 : 4)];
          const int i1 = x1 - w1 + (halo1 ? t1 : 0);
          v = sp[(halo1 ? 0 : B0) + (i1 * t2 + i2) * w0 + x0 % w0];
        } else if (own1) {
          const W* sp = slot[halo1 ? 2 : 6];
          v = sp[(halo2 ? 0 : B1) + (i2 * t0 + (x0 - w0)) * w1 + x1 % w1];
        } else {  // owner facet_2 (halo2)
          v = slot[3][((x0 - w0) * t1 + (x1 - w1)) * w2 + x2];
        }
      }
      pack.w[e] = v;
    }
    W* row = dst + (size_t)r * h2 + c * V;
    if (p.vec) {
      *reinterpret_cast<uint4*>(row) = pack.u;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c * V + e < h2) row[e] = pack.w[e];
    }
  }
}

template <typename W>
cudaError_t launch(const void* f0, const void* f1, const void* f2, void* out, Params& p,
                   unsigned blocks, cudaStream_t st) {
  auto kernel = facet_fetch_kernel<W>;
  p.vec = p.h[2] % (16 / (int)sizeof(W)) == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  static int smem_set = 48 * 1024;  // raised once per size, not per call
  if (p.smem > smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    smem_set = p.smem;
  }
  kernel<<<blocks, kThreads, p.smem, st>>>(static_cast<const W*>(f0), static_cast<const W*>(f1),
                                           static_cast<const W*>(f2), static_cast<W*>(out), p);
  return cudaGetLastError();
}

}  // namespace

// C entry point.  Pointers and the stream come in as void*; `ints` holds
// g[3], w[3], t[3], irredundant, staged shared bytes (0: read in place);
// `slots` holds per slot (4 redundant, 7 irredundant) facet, c, s[3], byte
// offset in shared memory, start, len (int64, slot first).  Returns the
// cudaError_t of the launch (0 = launched), or cudaErrorInvalidValue for an
// argument the kernel does not take.
extern "C" int facet_fetch(int elem_bytes, const void* f0, const void* f1, const void* f2,
                           void* out, const int* ints, const int64_t* slots, void* stream) {
  Params p;
  for (int a = 0; a < 3; ++a) {
    p.g[a] = ints[a];
    p.w[a] = ints[3 + a];
    p.t[a] = ints[6 + a];
    p.h[a] = p.w[a] + p.t[a];
    if (p.g[a] < 1 || p.w[a] < 1 || p.t[a] < p.w[a] || p.t[a] % p.w[a]) {
      return (int)cudaErrorInvalidValue;
    }
  }
  p.irredundant = ints[9] != 0;
  p.n_slots = p.irredundant ? 7 : 4;
  p.smem = ints[10];
  if (p.smem < 0 || (size_t)p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < p.n_slots; ++s) {
    const int64_t* r = slots + 8 * s;
    p.facet[s] = (int)r[0];
    p.c[s] = r[1];
    for (int a = 0; a < 3; ++a) p.s[s][a] = r[2 + a];
    p.off[s] = (int)r[5];
    p.start[s] = r[6];
    p.len[s] = r[7];
    if (p.facet[s] < 0 || p.facet[s] > 2 || p.len[s] < 1 || p.off[s] % 16 ||
        (p.smem && p.off[s] + p.len[s] * elem_bytes > p.smem))
      return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (int64_t)p.g[0] * p.g[1] * p.g[2];
  if (blocks > 0x7fffffff || (int64_t)p.h[0] * p.h[1] * p.h[2] > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return (int)launch<uint32_t>(f0, f1, f2, out, p, (unsigned)blocks, st);
  if (elem_bytes == 8) return (int)launch<uint64_t>(f0, f1, f2, out, p, (unsigned)blocks, st);
  return (int)cudaErrorInvalidValue;
}
