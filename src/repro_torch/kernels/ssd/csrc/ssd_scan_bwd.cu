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
//   dS_prev = exp(l_L) dS_next + U,   U = sum_t exp(l_t) dy_t (outer) C_t
//   dx_s    = sum_{t>=s} W[t,s] dy_t + exp(l_L - l_s) dS_next B_s
//   dG[t,s] = sum_h [s<=t] exp(l_t - l_s) (dy_t . x_s)           (over heads)
//   dC_t    = sum_s dG[t,s] B_s + sum_h exp(l_t) dy_t^T S_prev
//   dB_s    = sum_t dG[t,s] C_t + sum_h exp(l_L - l_s) x_s^T dS_next
//   dl_t    = sum_s A[t,s] - sum_u A[u,t]   (A = W o (dy_t . x_s), s <= t)
//           + exp(l_t) dy_t . (S_prev C_t) - exp(l_L - l_t) x_t . (dS_next B_t)
//           + [t = L-1] (exp(l_L) <dS_next, S_prev> + sum_s exp(l_L - l_s) x_s . (dS_next B_s))
//   dloga_s = sum_{t>=s} dl_t (a reverse cumsum inside the chunk).
//
// What bounds it: at the training shape (B 8, T 4096, H 32, P 64, N 128,
// L 128, bf16) a call moves 713 MB (x, dy, the saved states, B, C and the
// outputs once: 0.213 ms at 3.35 TB/s) and does 106 GFLOP of chunk products
// (0.108 ms on the bf16 tensor cores, 1.59 ms on the FP32 pipes); at the
// serve shape (B 1, T 1024) 22 MB and 3.3 GFLOP.  Bytes bound it once the
// products run on the tensor cores.
//
// What held the first version back (20.8 ms at the training shape on an
// H100, chip_smoke.py): each CTA of 16 rows p walked all 32 chunks in order
// and did every chunk product inside that serial walk (W^T dy, the facet
// term dS_next B and the dS update) as FP32 FMAs out of shared memory, with
// W rebuilt from G with one expf per element by each of a head's four CTAs;
// 150 KB of shared memory held one 8-warp CTA per SM; dB and dC looped 32
// heads x 8 tiles serially in 256 CTAs; no tensor cores anywhere.
//
// The design: the walk's only serial dependence is the recurrence dS_prev =
// exp(l_L) dS_next + U, whose U is chunk-local.  So one cheap serial pass
// sits between chunk-parallel launches, four on one stream (grids flattened
// to (units, B), so no count but B meets a grid limit):
//
//   1. local  (H + 1) x nc CTAs per row: U of chunk c (its dS_prev term) into
//      the dS_next scratch at slot c - 1; every chunk and head's decay tables
//      (the cumsum l, the factors below, exp(l_t), exp(l_L - l_t)) into a
//      scratch the later launches copy; the final state's gradient into slot
//      nc - 1 (chunk 0's CTAs); the CTAs of head index H write G^T = B C^T of
//      the chunk (once per row and chunk, shared by every head);
//   2. pass   one thread per 4 elements of (head, p, n): dS_next(c - 1) =
//      exp(l_L,c) dS_next(c) + U_c from the last chunk to the first, in
//      place (about 2 x 268 MB of traffic at the training shape);
//   3. head   H x nc CTAs per row: everything per head and chunk: Y = C
//      S_prev^T and Z = B dS_next^T (the dl facet terms), dx = W^T dy +
//      exp(l_L - l_s) Z, D^T = x dy^T with A^T = W^T o D^T (the intra-chunk
//      dl), and the reverse cumsum into dloga.  Warp w owns s-block w;
//   4. cross  2 ceil(N/64) x nc CTAs per row: per row and chunk, the sums
//      over heads: one CTA kind per 64 columns of dC (rows t: dG B + sum_h
//      exp(l_t) dy S_prev) and of dB (rows s: dG^T C + sum_h exp(l_L - l_s)
//      x dS_next).  Each kind recomputes D per head in its own orientation;
//      dG accumulates in head order in shared memory (its blocks spread over
//      the warps), the per-head products in registers: a fixed order, no
//      atomics, no partials in device memory.
//
// Scratch beside the outputs: dS_next (B, nc, H, P, N) f32 (268 MB at the
// training shape, as much as the saved states), G^T (B, nc, Lp, Lp) f32
// (16.8 MB) and the tables (B, nc, H, 5 Lp + 64) f32 (23 MB).  A call is
// deterministic (the same inputs give the same bits) and capturable in a
// CUDA graph: no host read, no allocation, no atomics.
//
// bfloat16 (the training route): every chunk product on the tensor cores,
// mma.sync m16n8k16 (bf16 in, f32 accumulate) from ldmatrix over rows padded
// by 8 elements, with L (and P, N inside their tiles) padded to multiples of
// 16 by zeros; B, C, x and dy staged by cp.async, the f32 states loaded by
// each thread all at once before they are split; the decay factored as R[t]
// M[tb][sb] Q[s] below the diagonal 16 x 16 block (the forward's tables), exp
// per element on the diagonal block only.  Precision: one operand of each
// product is exact in bf16 (dy, which the wrapper casts to the input type, x,
// B or C); the other is an f32 value (W, exp(l) o dy, dS_next, S_prev or
// dG), which goes in as a hi and a lo bf16 half (hi = bf16(v), lo = bf16(v -
// hi)) through two MMAs into one accumulator: 2^-17 relative, against 2^-9
// for one rounding (which breaks the dloga limit for dS_next, S_prev and
// exp(l) o dy, and the dB / dC limit for dG).  Launches 3 and 4 hold two
// CTAs per SM (at most 113 KB of shared memory each), launch 1 two.  float32
// keeps FP32 FMAs (exact fused multiply-adds out of shared memory) in the
// same four grids.
//
// What still holds it back (the times are chip_smoke.py's, in PERF.md): a
// call runs at about a tenth of its bytes bound, most of it in `head` and
// `cross`.  The products run through mma.sync with every warp loading its
// own fragments by ldmatrix, so shared-memory traffic and latency, not the
// tensor cores, pace them; each CTA stages its operands, then computes, with
// no ring (overlap comes only from the second CTA on the SM); `cross`
// computes D four times per head (two kinds x two column groups) and runs
// 32 CTAs at the serve shape.  wgmma with operands
// in shared memory, a TMA ring fed by a producer warp, and D shared across
// the kinds are the next steps.
//
// x, dy, B and C come in float32 or bfloat16; dx, dB and dC go out in that
// dtype, dloga in float32.  L <= 128, N <= 256, any P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // every launch: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kMaxN = 256;
constexpr int kPT = 64;         // p-tile of the bf16 local, head and cross launches
constexpr int kKN = 128;        // n-chunk of the bf16 head launch
constexpr int kNG = 64;         // columns of dB / dC per cross CTA (both routes)
constexpr int kLdP = kPT + 8;   // bf16 row stride of x, dy and 64-wide slices
constexpr int kLdN = kKN + 8;   // bf16 row stride of 128-wide slices
constexpr int kFP = 32;         // p-tile of the float32 launches
constexpr int kFN = 32;         // n-chunk of the float32 head launch
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// -- shared helpers ----------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float d[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand: rows [r0, r0 + 16), k [k0, k0 + 16) of a row-major bf16 array
__device__ __forceinline__ void lda(unsigned a[4], const bf16* base, int ld, int r0, int k0,
                                    int lane) {
  ldsm_x4(a, base + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B operand of two n8 tiles, columns [c0, c0 + 16), k [k0, k0 + 16), from an
// array stored [column][k]: b[0], b[1] the first tile, b[2], b[3] the second
__device__ __forceinline__ void ldb_nk(unsigned b[4], const bf16* base, int ld, int c0, int k0,
                                       int lane) {
  ldsm_x4(b, base + (c0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// the same from an array stored [k][column]
__device__ __forceinline__ void ldb_kn(unsigned b[4], const bf16* base, int ld, int c0, int k0,
                                       int lane) {
  ldsm_x4_t(b, base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + (lane >> 4) * 8);
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

// v = hi + lo, each bf16: the two halves of a split f32 pair (a, b), a in
// the low half (one packed conversion per half)
__device__ __forceinline__ void split2(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// A operand halves of a 16x16 f32 block in the accumulator layout of two n8
// tiles (the accumulator layout of two n8 tiles is the A layout of one k16 step)
__device__ __forceinline__ void split_block(const float (&v)[2][4], unsigned (&ah)[4],
                                            unsigned (&al)[4]) {
  split2(v[0][0], v[0][1], ah[0], al[0]);
  split2(v[0][2], v[0][3], ah[1], al[1]);
  split2(v[1][0], v[1][1], ah[2], al[2]);
  split2(v[1][2], v[1][3], ah[3], al[3]);
}

// inclusive cumsum of the chunk's log-decays of head h over lp rows (rows t
// >= L add 0): warp 0, four consecutive steps per lane, then a shuffle scan;
// the caller syncs
__device__ __forceinline__ void cumsum_warp0(float* lc, const float* loga, size_t row0, int H,
                                             int h, int L, int lp) {
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
      if (t < lp) lc[t] = v[i] + excl;
    }
  }
}

// dl per step (`dl(t)`, t < L) into dloga as its reverse cumsum inside the
// chunk: warp 0, four consecutive steps per lane, then a shuffle scan
template <typename F>
__device__ __forceinline__ void reverse_cumsum_warp0(float* dloga, size_t row0, int H, int h,
                                                     int L, F dl) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      v[i] = t < L ? dl(t) : 0.0f;
    }
    float run = 0.0f;
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      run += v[i];
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    const float excl = incl - run;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      if (t < L) dloga[(row0 + t) * H + h] = v[i] + excl;
    }
  }
}

// sum over a warp's lanes by a fixed butterfly (every lane gets the same bits)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum over the four lanes of a quad (an accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the final state's gradient (null: zero) seeds slot nc - 1 of the scratch
__device__ void seed_last(float* dstates, const float* dfinal, int b, int h, int nc, int H,
                          int P, int N) {
  float* dst = dstates + (((size_t)b * nc + nc - 1) * H + h) * P * N;
  const float* src = dfinal ? dfinal + ((size_t)b * H + h) * P * N : nullptr;
  for (int i = threadIdx.x; i < P * N; i += kThreads) dst[i] = src ? src[i] : 0.0f;
}

// -- bfloat16: staging -------------------------------------------------------------

// rows [0, nrows) x columns [0, ncols) of a bf16 matrix (row r at src + r *
// stride) into dst[r * ld + col], zero where r >= rvalid or col >= cvalid;
// ncols a multiple of 8; 16-byte cp.async copies where a segment is valid
// and `vec` (16-byte aligned rows), else element by element
__device__ void stage_bf16(bf16* dst, int ld, const bf16* src, size_t stride, int nrows,
                           int ncols, int rvalid, int cvalid, bool vec) {
  const int segs = ncols / 8;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < nrows * segs; i += kThreads) {
    const int r = i / segs, j = (i - r * segs) * 8;
    bf16* d = dst + r * ld + j;
    if (vec && r < rvalid && j + 8 <= cvalid) {
      cp_async16(d, src + r * stride + j);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] = (r < rvalid && j + k < cvalid) ? src[r * stride + j + k] : zero;
    }
  }
}

// rows x columns (at most MAXK * kThreads column pairs) of an f32 matrix as
// hi and lo bf16 halves, zero where invalid: each thread first loads all of
// its pairs (one memory latency, not one per pair), then splits and stores
// them; with DOT, returns this thread's sum of v * w over its elements (`w`
// a second matrix of the same layout)
template <int MAXK, bool DOT>
__device__ float stage_split(bf16* hi, bf16* lo, int ld, const float* src, const float* w,
                             size_t stride, int nrows, int ncols, int rvalid, int cvalid) {
  const int pairs = ncols / 2, total = nrows * pairs;
  float2 v[MAXK], u[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = make_float2(0.0f, 0.0f);
    u[k] = make_float2(0.0f, 0.0f);
    if (i < total) {
      const int r = i / pairs, j = (i - r * pairs) * 2;
      if (r < rvalid) {
        const size_t o = r * stride + j;
        if (j < cvalid) {
          v[k].x = src[o];
          if (DOT) u[k].x = w[o];
        }
        if (j + 1 < cvalid) {
          v[k].y = src[o + 1];
          if (DOT) u[k].y = w[o + 1];
        }
      }
    }
  }
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < total) {
      const int r = i / pairs, j = (i - r * pairs) * 2;
      if (DOT) {
        dot = __fmaf_rn(v[k].x, u[k].x, dot);
        dot = __fmaf_rn(v[k].y, u[k].y, dot);
      }
      unsigned h2, l2;
      split2(v[k].x, v[k].y, h2, l2);
      *reinterpret_cast<unsigned*>(hi + r * ld + j) = h2;
      *reinterpret_cast<unsigned*>(lo + r * ld + j) = l2;
    }
  }
  return dot;
}

// floats of one (row, chunk, head) block of the tables scratch: lcum, R, Q,
// exp(l_t) and exp(l_L - l_t) [lp] each, then M [8][8]; with a_b = lcum[16 b
// + 15], for t in block tb > sb >= blk(s): exp(l_t - l_s) = R[t] M[tb][sb]
// Q[s], each factor <= 1
__host__ __device__ inline int tab_floats(int lp) { return 5 * lp + 64; }

// the tables of a chunk and head (lcum in shared memory, lp rows) into their
// block of the scratch; the launches after `local` copy them
__device__ void write_tables(float* tab, const float* lcum, int L, int lp) {
  const float ltot = lcum[L - 1];
  for (int t = threadIdx.x; t < lp; t += kThreads) {
    const int blk = t / 16;
    tab[t] = lcum[t];
    tab[lp + t] = blk > 0 ? expf(lcum[t] - lcum[16 * blk - 1]) : 1.0f;
    tab[2 * lp + t] = expf(lcum[16 * blk + 15] - lcum[t]);
    tab[3 * lp + t] = expf(lcum[t]);
    tab[4 * lp + t] = expf(ltot - lcum[t]);
  }
  if (threadIdx.x < 64) {
    const int i = threadIdx.x / 8, jb = threadIdx.x % 8;
    tab[5 * lp + threadIdx.x] =
        jb < i && 16 * i < lp ? expf(lcum[16 * i - 1] - lcum[16 * jb + 15]) : 0.0f;
  }
}

// a block of the tables scratch into shared memory (cp.async; the caller commits)
__device__ __forceinline__ void copy_tables(float* dst, const float* src, int lp) {
  for (int i = threadIdx.x; i < tab_floats(lp) / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
}

// v (a 16x16 block in the accumulator layout, rows in block rb, columns in
// block cb) times exp(l_t - l_s), (t, s) = (row, column) if T_ROWS else
// (column, row); zero where t < s (no exp of a positive difference)
template <bool T_ROWS>
__device__ __forceinline__ void apply_decay(float (&v)[2][4], int rb, int cb, const float* lcum,
                                            const float* tR, const float* tQ, const float* tM,
                                            int lane) {
  const int gr = lane / 4, gc = lane % 4;
  const int tb = T_ROWS ? rb : cb, sb = T_ROWS ? cb : rb;
  if (tb > sb) {
    const float m = tM[8 * tb + sb];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rb + gr + (e < 2 ? 0 : 8), cc = 16 * cb + 8 * q + 2 * gc + (e & 1);
        const int t = T_ROWS ? r : cc, s = T_ROWS ? cc : r;
        v[q][e] *= tR[t] * m * tQ[s];
      }
  } else if (tb == sb) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rb + gr + (e < 2 ? 0 : 8), cc = 16 * cb + 8 * q + 2 * gc + (e & 1);
        const int t = T_ROWS ? r : cc, s = T_ROWS ? cc : r;
        v[q][e] = t >= s ? v[q][e] * expf(lcum[t] - lcum[s]) : 0.0f;
      }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[q][e] = 0.0f;
  }
}

// -- bfloat16: shared-memory layouts (byte offsets) ------------------------------------

// 1. local: C [lp][np + 8] (and B for the G CTAs) or, for U, (exp(l) o dy)^T
// split [2][kPT][lp + 8], lcum and exp(l) [lp], and a p-tile of dy [lp][kLdP]
struct LocalLayout {
  int lp, np, ldg, off_b, off_a, off_tab, off_dy, total;
};

__host__ __device__ inline LocalLayout local_layout(int L, int N) {
  LocalLayout g;
  g.lp = round16(L);
  g.np = round16(N);
  g.ldg = g.np + 8;
  const int arr = g.lp * g.ldg * 2;
  g.off_b = arr;
  g.off_a = arr;
  g.off_tab = g.off_a + 2 * kPT * (g.lp + 8) * 2;
  g.off_dy = g.off_tab + 2 * g.lp * 4;
  g.total = imax(2 * arr, g.off_dy + g.lp * kLdP * 2);
  return g;
}

// 3. head: one 128-wide n-chunk of C or B [lp][kLdN]; x, dy [lp][kLdP]; a
// state's n-chunk split [2][kPT][kLdN]; the chunk and head's tables; the dl partials: column sums of A^T per s-block warp [kWarps][lp],
// its row sums, x.Z and dy.Y [lp]
struct HeadLayout {
  int lp, off_x, off_dy, off_s, off_tab, total;
};

__host__ __device__ inline HeadLayout head_layout(int L) {
  HeadLayout g;
  g.lp = round16(L);
  g.off_x = g.lp * kLdN * 2;
  g.off_dy = g.off_x + g.lp * kLdP * 2;
  g.off_s = g.off_dy + g.lp * kLdP * 2;
  g.off_tab = g.off_s + 2 * kPT * kLdN * 2;
  g.total = g.off_tab + 4 * (tab_floats(g.lp) + (kWarps + 3) * g.lp);
  return g;
}

// 4. cross: the row and column operands (dy and x) [lp][kLdP]; the state's
// p-tile x 64 columns split [2][kPT][kLdP]; the 64 columns of B or C
// [lp][kLdP]; dG, 16x16 f32 blocks of the warps' lower (dC) or upper (dB)
// triangle; the chunk and head's tables
struct CrossLayout {
  int lp, off_cl, off_st, off_y, off_dg, off_tab, total;
};

__host__ __device__ inline CrossLayout cross_layout(int L) {
  CrossLayout g;
  g.lp = round16(L);
  const int nb = g.lp / 16;
  g.off_cl = g.lp * kLdP * 2;
  g.off_st = 2 * g.off_cl;
  g.off_y = g.off_st + 2 * kPT * kLdP * 2;
  g.off_dg = g.off_y + g.lp * kLdP * 2;
  g.off_tab = g.off_dg + nb * (nb + 1) / 2 * 256 * 4;
  g.total = g.off_tab + 4 * tab_floats(g.lp);
  return g;
}

// -- bfloat16: the launches --------------------------------------------------------------

// 1. the chunk and head's tables, U of chunk c into slot c - 1, the seed of
// slot nc - 1, and (x-index H) G^T of the chunk
__global__ void __launch_bounds__(kThreads)
local_mma(const bf16* __restrict__ dy, const float* __restrict__ loga, const bf16* __restrict__ Bm,
          const bf16* __restrict__ C, const float* __restrict__ dfinal,
          float* __restrict__ dstates, float* __restrict__ gram, float* __restrict__ tabs, int T,
          int H, int P, int N, int L, LocalLayout g, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x % (H + 1), c = blockIdx.x / (H + 1), b = blockIdx.y, nc = T / L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, gc = lane % 4;
  const size_t row0 = (size_t)b * T + (size_t)c * L;
  const int nb = g.lp / 16;
  bf16* cs = reinterpret_cast<bf16*>(smem);
  if (h == H) {  // G^T[s, t] = B_s . C_t, the blocks (sb, tb >= sb)
    bf16* bs = reinterpret_cast<bf16*>(smem + g.off_b);
    stage_bf16(cs, g.ldg, C + row0 * N, N, g.lp, g.np, L, N, vec);
    stage_bf16(bs, g.ldg, Bm + row0 * N, N, g.lp, g.np, L, N, vec);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    float* gt = gram + ((size_t)b * nc + c) * g.lp * g.lp;
    for (int u = warp; u < nb * (nb + 1) / 2; u += kWarps) {
      int sb = 0, rem = u;
      while (rem >= nb - sb) {
        rem -= nb - sb;
        ++sb;
      }
      const int tb = sb + rem;
      float acc[2][4] = {};
      for (int k0 = 0; k0 < g.np; k0 += 16) {
        unsigned a[4], bb[4];
        lda(a, bs, g.ldg, 16 * sb, k0, lane);
        ldb_nk(bb, cs, g.ldg, 16 * tb, k0, lane);
        mma(acc[0], a, bb[0], bb[1]);
        mma(acc[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float* o = gt + (size_t)(16 * sb + gr) * g.lp + 16 * tb + 8 * q + 2 * gc;
        *reinterpret_cast<float2*>(o) = make_float2(acc[q][0], acc[q][1]);
        *reinterpret_cast<float2*>(o + 8 * g.lp) = make_float2(acc[q][2], acc[q][3]);
      }
    }
    return;
  }
  // U = (exp(l) o dy)^T C: rows p, k = t
  float* lcum = reinterpret_cast<float*>(smem + g.off_tab);
  float* el = lcum + g.lp;
  bf16* dys = reinterpret_cast<bf16*>(smem + g.off_dy);
  const int lda_ = g.lp + 8;
  bf16* a_hi = reinterpret_cast<bf16*>(smem + g.off_a);
  bf16* a_lo = a_hi + kPT * lda_;
  if (c > 0) {
    stage_bf16(cs, g.ldg, C + row0 * N, N, g.lp, g.np, L, N, vec);
    cp_commit();
  }
  cumsum_warp0(lcum, loga, row0, H, h, L, g.lp);
  __syncthreads();
  write_tables(tabs + ((size_t)b * nc + c) * H * tab_floats(g.lp) + (size_t)h * tab_floats(g.lp),
               lcum, L, g.lp);
  if (c == 0) {
    seed_last(dstates, dfinal, b, h, nc, H, P, N);
    return;
  }
  for (int t = threadIdx.x; t < g.lp; t += kThreads) el[t] = expf(lcum[t]);
  __syncthreads();
  float* dst = dstates + (((size_t)b * nc + c - 1) * H + h) * P * N;
  const int nng = (g.np + kNG - 1) / kNG;
  for (int p0 = 0; p0 < P; p0 += kPT) {
    const int pw = min(kPT, P - p0), pp = round16(pw), npb = pp / 16;
    stage_bf16(dys, kLdP, dy + row0 * H * P + (size_t)h * P + p0, (size_t)H * P, g.lp, pp, L, pw,
               vec);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    // (exp(l) o dy)^T split, [p][t] with t in pairs, from the staged tile
    for (int i = threadIdx.x; i < pp * g.lp / 2; i += kThreads) {
      const int p = i % pp, t2 = 2 * (i / pp);
      unsigned hi, lo;
      split2(el[t2] * __bfloat162float(dys[t2 * kLdP + p]),
             el[t2 + 1] * __bfloat162float(dys[(t2 + 1) * kLdP + p]), hi, lo);
      *reinterpret_cast<unsigned*>(a_hi + p * lda_ + t2) = hi;
      *reinterpret_cast<unsigned*>(a_lo + p * lda_ + t2) = lo;
    }
    cp_wait_all();
    __syncthreads();
    for (int u = warp; u < npb * nng; u += kWarps) {
      const int pb = u % npb, ng = u / npb;
      const int nt = min(8, (g.np - kNG * ng) / 8);  // n8 tiles of this group (even)
      float acc[8][4] = {};
      for (int k0 = 0; k0 < g.lp; k0 += 16) {
        unsigned ah[4], al[4];
        lda(ah, a_hi, lda_, 16 * pb, k0, lane);
        lda(al, a_lo, lda_, 16 * pb, k0, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (2 * j < nt) {
            unsigned bb[4];
            ldb_kn(bb, cs, g.ldg, kNG * ng + 16 * j, k0, lane);
            mma(acc[2 * j], ah, bb[0], bb[1]);
            mma(acc[2 * j], al, bb[0], bb[1]);
            mma(acc[2 * j + 1], ah, bb[2], bb[3]);
            mma(acc[2 * j + 1], al, bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = 16 * pb + gr + 8 * hf, n = kNG * ng + 8 * j + 2 * gc;
            if (p < pw) {
              float* o = dst + (size_t)(p0 + p) * N + n;
              if (n + 1 < N && (N % 2) == 0) {
                *reinterpret_cast<float2*>(o) = make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
              } else {
                if (n < N) o[0] = acc[j][2 * hf];
                if (n + 1 < N) o[1] = acc[j][2 * hf + 1];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // before the next p-tile overwrites the split operand
  }
}

// 2. the state-passing recurrence, in place: slot c <- exp(l_L of chunk c+1)
// slot c+1 + slot c, from the last chunk to the first; V elements a thread.
// The decay of (row, chunk, head) is decay[((b nc + c) H + h) ds].
template <int V>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const float* __restrict__ decay, int ds, float* __restrict__ dstates, int nc, int H,
            int PN) {
  const int b = blockIdx.y;
  const size_t per = (size_t)H * PN;
  const size_t i = ((size_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (i >= per) return;
  const int h = (int)(i / PN);
  float* base = dstates + (size_t)b * nc * per + i;
  const float* dec = decay + ((size_t)b * nc * H + h) * ds;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = base[(size_t)(nc - 1) * per + k];
  for (int c = nc - 2; c >= 0; c -= 4) {
    float u[4][V], e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // loads for four chunks ahead of their chain
      if (c - j >= 0) {
        e[j] = dec[(size_t)(c - j + 1) * H * ds];
        if constexpr (V == 4) {
          const float4 v = *reinterpret_cast<const float4*>(base + (size_t)(c - j) * per);
          u[j][0] = v.x;
          u[j][1] = v.y;
          u[j][2] = v.z;
          u[j][3] = v.w;
        } else {
          u[j][0] = base[(size_t)(c - j) * per];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c - j >= 0) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = __fmaf_rn(e[j], acc[k], u[j][k]);
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(base + (size_t)(c - j) * per) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
          base[(size_t)(c - j) * per] = acc[0];
        }
      }
    }
  }
}

// 3. per head and chunk: dx and dloga
__global__ void __launch_bounds__(kThreads, 2)
head_mma(const bf16* __restrict__ x, const float* __restrict__ tabs, const bf16* __restrict__ Bm,
         const bf16* __restrict__ C, const float* __restrict__ states, const bf16* __restrict__ dy,
         const float* __restrict__ dstates, const float* __restrict__ gram, bf16* __restrict__ dx,
         float* __restrict__ dloga, int T, int H, int P, int N, int L, HeadLayout g, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y, nc = T / L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, gc = lane % 4;
  const int lp = g.lp, nb = lp / 16;
  const size_t row0 = (size_t)b * T + (size_t)c * L;
  bf16* ns = reinterpret_cast<bf16*>(smem);  // the n-chunk of C, then of B
  bf16* xs = reinterpret_cast<bf16*>(smem + g.off_x);
  bf16* dys = reinterpret_cast<bf16*>(smem + g.off_dy);
  bf16* s_hi = reinterpret_cast<bf16*>(smem + g.off_s);  // S_prev, then dS_next
  bf16* s_lo = s_hi + kPT * kLdN;
  float* lcum = reinterpret_cast<float*>(smem + g.off_tab);
  float* tR = lcum + lp;
  float* tQ = tR + lp;
  float* tE = tQ + lp;  // exp(l_t)
  float* tW = tE + lp;  // exp(l_L - l_s)
  float* tM = tW + lp;
  float* colp = tM + 64;              // [kWarps][lp] column sums of A^T
  float* rows = colp + kWarps * lp;   // [lp] row sums of A^T
  float* xz = rows + lp;              // [lp] x_s . (dS_next B_s)
  float* ry = xz + lp;                // [lp] dy_t . (S_prev C_t)
  float* sdp = reinterpret_cast<float*>(smem + g.off_x);  // [kThreads], after the last p-tile

  for (int i = threadIdx.x; i < (kWarps + 3) * lp; i += kThreads) colp[i] = 0.0f;
  // (the tables arrive with the first staging's barrier)
  copy_tables(lcum, tabs + (((size_t)b * nc + c) * H + h) * tab_floats(lp), lp);
  const size_t sbase = (((size_t)b * nc + c) * H + h) * P * N;
  const float* gt = gram + ((size_t)b * nc + c) * lp * lp;
  const size_t xrow = (size_t)H * P;
  const bf16* xsrc = x + row0 * xrow + (size_t)h * P;
  const bf16* dysrc = dy + row0 * xrow + (size_t)h * P;
  const int sb = warp;  // this warp's s-block (and t-block of Y)
  const bool active = sb < nb;
  float sd = 0.0f;
  for (int p0 = 0; p0 < P; p0 += kPT) {
    const int pw = min(kPT, P - p0), pp = round16(pw), np2 = pp / 16;
    stage_bf16(xs, kLdP, xsrc + p0, xrow, lp, pp, L, pw, vec);
    stage_bf16(dys, kLdP, dysrc + p0, xrow, lp, pp, L, pw, vec);
    // ---- Y = C S_prev^T (rows t of block sb): dy_t . Y_t into ry
    float acc[8][4] = {};
    for (int n0 = 0; n0 < N; n0 += kKN) {
      const int nw = min(kKN, N - n0), nn = round16(nw);
      stage_bf16(ns, kLdN, C + row0 * N + n0, N, lp, nn, L, nw, vec);
      cp_commit();
      stage_split<kPT * kKN / 2 / kThreads, false>(s_hi, s_lo, kLdN,
                                                   states + sbase + (size_t)p0 * N + n0, nullptr,
                                                   N, pp, nn, pw, nw);
      cp_wait_all();
      __syncthreads();
      if (active) {
        for (int k0 = 0; k0 < nn; k0 += 16) {
          unsigned a[4];
          lda(a, ns, kLdN, 16 * sb, k0, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < np2) {
              unsigned bh[4], bl[4];
              ldb_nk(bh, s_hi, kLdN, 16 * j, k0, lane);
              ldb_nk(bl, s_lo, kLdN, 16 * j, k0, lane);
              mma(acc[2 * j], a, bh[0], bh[1]);
              mma(acc[2 * j], a, bl[0], bl[1]);
              mma(acc[2 * j + 1], a, bh[2], bh[3]);
              mma(acc[2 * j + 1], a, bl[2], bl[3]);
            }
          }
        }
      }
      __syncthreads();
    }
    if (active) {
      float r2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 2 * np2) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const __nv_bfloat162 d2 =
                *reinterpret_cast<const __nv_bfloat162*>(dys + (16 * sb + gr + 8 * hf) * kLdP + 8 * j + 2 * gc);
            const float2 df = __bfloat1622float2(d2);
            r2[hf] = __fmaf_rn(df.x, acc[j][2 * hf], r2[hf]);
            r2[hf] = __fmaf_rn(df.y, acc[j][2 * hf + 1], r2[hf]);
          }
        }
      }
      r2[0] = quad_sum(r2[0]);
      r2[1] = quad_sum(r2[1]);
      if (gc == 0) {
        ry[16 * sb + gr] += r2[0];
        ry[16 * sb + gr + 8] += r2[1];
      }
    }
    // ---- Z = B dS_next^T (rows s of block sb), then x_s . Z_s into xz
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    for (int n0 = 0; n0 < N; n0 += kKN) {
      const int nw = min(kKN, N - n0), nn = round16(nw);
      stage_bf16(ns, kLdN, Bm + row0 * N + n0, N, lp, nn, L, nw, vec);
      cp_commit();
      sd += stage_split<kPT * kKN / 2 / kThreads, true>(
          s_hi, s_lo, kLdN, dstates + sbase + (size_t)p0 * N + n0,
          states + sbase + (size_t)p0 * N + n0, N, pp, nn, pw, nw);
      cp_wait_all();
      __syncthreads();
      if (active) {
        for (int k0 = 0; k0 < nn; k0 += 16) {
          unsigned a[4];
          lda(a, ns, kLdN, 16 * sb, k0, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < np2) {
              unsigned bh[4], bl[4];
              ldb_nk(bh, s_hi, kLdN, 16 * j, k0, lane);
              ldb_nk(bl, s_lo, kLdN, 16 * j, k0, lane);
              mma(acc[2 * j], a, bh[0], bh[1]);
              mma(acc[2 * j], a, bl[0], bl[1]);
              mma(acc[2 * j + 1], a, bh[2], bh[3]);
              mma(acc[2 * j + 1], a, bl[2], bl[3]);
            }
          }
        }
      }
      __syncthreads();
    }
    if (active) {
      float r2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 2 * np2) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const __nv_bfloat162 x2 =
                *reinterpret_cast<const __nv_bfloat162*>(xs + (16 * sb + gr + 8 * hf) * kLdP + 8 * j + 2 * gc);
            const float2 xf = __bfloat1622float2(x2);
            r2[hf] = __fmaf_rn(xf.x, acc[j][2 * hf], r2[hf]);
            r2[hf] = __fmaf_rn(xf.y, acc[j][2 * hf + 1], r2[hf]);
          }
        }
      }
      r2[0] = quad_sum(r2[0]);
      r2[1] = quad_sum(r2[1]);
      if (gc == 0) {
        xz[16 * sb + gr] += r2[0];
        xz[16 * sb + gr + 8] += r2[1];
      }
      // ---- dx = wout o Z + sum_{tb >= sb} W^T[sb, tb] dy[tb]; and A^T = W^T o D^T
      const float wa = tW[16 * sb + gr], wb = tW[16 * sb + gr + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= wa;
        acc[j][1] *= wa;
        acc[j][2] *= wb;
        acc[j][3] *= wb;
      }
      float rs[2] = {0.0f, 0.0f};
      // this warp's G^T blocks (sb, tb >= sb), each loaded one unit ahead
      const float* grow = gt + (size_t)(16 * sb + gr) * lp + 2 * gc;
      float2 gn[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        gn[q][0] = *reinterpret_cast<const float2*>(grow + 16 * sb + 8 * q);
        gn[q][1] = *reinterpret_cast<const float2*>(grow + 8 * lp + 16 * sb + 8 * q);
      }
      for (int tb = sb; tb < nb; ++tb) {
        float w[2][4], d[2][4] = {};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          w[q][0] = gn[q][0].x;
          w[q][1] = gn[q][0].y;
          w[q][2] = gn[q][1].x;
          w[q][3] = gn[q][1].y;
        }
        if (tb + 1 < nb) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            gn[q][0] = *reinterpret_cast<const float2*>(grow + 16 * (tb + 1) + 8 * q);
            gn[q][1] = *reinterpret_cast<const float2*>(grow + 8 * lp + 16 * (tb + 1) + 8 * q);
          }
        }
        apply_decay<false>(w, sb, tb, lcum, tR, tQ, tM, lane);
        for (int k0 = 0; k0 < pp; k0 += 16) {
          unsigned a[4], bb[4];
          lda(a, xs, kLdP, 16 * sb, k0, lane);
          ldb_nk(bb, dys, kLdP, 16 * tb, k0, lane);
          mma(d[0], a, bb[0], bb[1]);
          mma(d[1], a, bb[2], bb[3]);
        }
        float cs[2][2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float a0 = w[q][j] * d[q][j], a1 = w[q][j + 2] * d[q][j + 2];
            rs[0] += a0;
            rs[1] += a1;
            cs[q][j] = a0 + a1;
          }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v = cs[q][j];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (gr == 0) colp[sb * lp + 16 * tb + 8 * q + 2 * gc + j] += v;
          }
        unsigned ah[4], al[4];
        split_block(w, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < np2) {
            unsigned bb[4];
            ldb_kn(bb, dys, kLdP, 16 * j, 16 * tb, lane);
            mma(acc[2 * j], ah, bb[0], bb[1]);
            mma(acc[2 * j], al, bb[0], bb[1]);
            mma(acc[2 * j + 1], ah, bb[2], bb[3]);
            mma(acc[2 * j + 1], al, bb[2], bb[3]);
          }
        }
      }
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
      if (gc == 0) {
        rows[16 * sb + gr] += rs[0];
        rows[16 * sb + gr + 8] += rs[1];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 2 * np2) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int s = 16 * sb + gr + 8 * hf, p = p0 + 8 * j + 2 * gc;
            if (s < L) {
              bf16* o = dx + (row0 + s) * xrow + (size_t)h * P + p;
              if (p + 1 < P && (P % 2) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(o) =
                    __floats2bfloat162_rn(acc[j][2 * hf], acc[j][2 * hf + 1]);
              } else {
                if (p < P) o[0] = __float2bfloat16_rn(acc[j][2 * hf]);
                if (p + 1 < P) o[1] = __float2bfloat16_rn(acc[j][2 * hf + 1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // before the next p-tile's staging
  }
  sdp[threadIdx.x] = sd;
  __syncthreads();
  float last = 0.0f;
  if (warp == 0) {
    float s2 = 0.0f, f = 0.0f;
    for (int k = lane; k < kThreads; k += 32) s2 += sdp[k];
    for (int t = lane; t < L; t += 32) f = __fmaf_rn(tW[t], xz[t], f);
    last = __fmaf_rn(tE[L - 1], warp_sum(s2), warp_sum(f));
  }
  reverse_cumsum_warp0(dloga, row0, H, h, L, [&](int t) {
    float cs = 0.0f;
    for (int w = 0; w < nb; ++w) cs += colp[w * lp + t];
    float dl = cs - rows[t] + tE[t] * ry[t] - tW[t] * xz[t];
    return t == L - 1 ? dl + last : dl;
  });
}

// 4. per row, chunk and 64 columns: dC (KIND 0, rows t) or dB (KIND 1, rows s)
template <int KIND>
__device__ __forceinline__ void cross_body(const bf16* __restrict__ x,
                                           const float* __restrict__ tabs,
                                           const bf16* __restrict__ Bm, const bf16* __restrict__ C,
                                           const float* __restrict__ states,
                                           const bf16* __restrict__ dy,
                                           const float* __restrict__ dstates,
                                           bf16* __restrict__ out, int T, int H, int P, int N,
                                           int L, const CrossLayout& g, bool vec,
                                           unsigned char* smem) {
  const int kinds = 2 * ((N + kNG - 1) / kNG);
  const int ng = (blockIdx.x % kinds) >> 1, c = blockIdx.x / kinds, b = blockIdx.y, nc = T / L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, gc = lane % 4;
  const int lp = g.lp, nb = lp / 16;
  const int n0 = kNG * ng, nw = min(kNG, N - n0), nn = round16(nw), nt = nn / 8;
  const size_t row0 = (size_t)b * T + (size_t)c * L;
  bf16* rw = reinterpret_cast<bf16*>(smem);  // the row operand: dy (dC) or x (dB)
  bf16* cl = reinterpret_cast<bf16*>(smem + g.off_cl);  // the column operand
  bf16* st_hi = reinterpret_cast<bf16*>(smem + g.off_st);
  bf16* st_lo = st_hi + kPT * kLdP;
  bf16* ys = reinterpret_cast<bf16*>(smem + g.off_y);
  float* dgs = reinterpret_cast<float*>(smem + g.off_dg);
  float* lcum = reinterpret_cast<float*>(smem + g.off_tab);
  float* tR = lcum + lp;
  float* tQ = tR + lp;
  float* tS = tQ + lp + (KIND == 0 ? 0 : lp);  // the row scale: exp(l_t) (dC) or exp(l_L - l_s) (dB)
  float* tM = tQ + 3 * lp;
  const bf16* rsrc = KIND == 0 ? dy : x;
  const bf16* csrc = KIND == 0 ? x : dy;
  const float* ssrc = KIND == 0 ? states : dstates;
  const size_t xrow = (size_t)H * P;
  const int i = warp;  // this warp's row block of the output
  const bool active = i < nb;
  // dG's blocks (bi, bj), bj <= bi (dC) or bj >= bi (dB), numbered row by row,
  // each 256 floats in the accumulator layout (8 a lane); block u's D is
  // computed by warp u % kWarps at every head, so the warps share the triangle
  const int nblk = nb * (nb + 1) / 2;
  for (int k = threadIdx.x; k < nblk * 256; k += kThreads) dgs[k] = 0.0f;
  const int jlo = KIND == 0 ? 0 : i, jhi = KIND == 0 ? i : nb - 1;
  const int first = KIND == 0 ? i * (i + 1) / 2 : i * nb - i * (i - 1) / 2;  // row i's first
  stage_bf16(ys, kLdP, (KIND == 0 ? Bm : C) + row0 * N + n0, N, lp, nn, L, nw, vec);
  float acc[8][4] = {};  // the output's 64 columns of this row block
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // every warp is done with the previous head's tables and tiles
    // (the tables arrive with the first p-tile's barrier)
    copy_tables(lcum, tabs + (((size_t)b * nc + c) * H + h) * tab_floats(lp), lp);
    const size_t sbase = (((size_t)b * nc + c) * H + h) * P * N;
    float ra[8][4] = {};
    for (int p0 = 0; p0 < P; p0 += kPT) {
      const int pw = min(kPT, P - p0), pp = round16(pw);
      if (p0 > 0) __syncthreads();
      stage_bf16(rw, kLdP, rsrc + row0 * xrow + (size_t)h * P + p0, xrow, lp, pp, L, pw, vec);
      stage_bf16(cl, kLdP, csrc + row0 * xrow + (size_t)h * P + p0, xrow, lp, pp, L, pw, vec);
      cp_commit();
      stage_split<kPT * kNG / 2 / kThreads, false>(st_hi, st_lo, kLdP,
                                                   ssrc + sbase + (size_t)p0 * N + n0, nullptr,
                                                   N, pp, nn, pw, nw);
      cp_wait_all();
      __syncthreads();
      // D blocks (rows of block bi, columns of block bj), decayed, into dG
      for (int u = warp; u < nblk; u += kWarps) {
        int bi = 0, rem = u;
        while (rem >= (KIND == 0 ? bi + 1 : nb - bi)) {
          rem -= KIND == 0 ? bi + 1 : nb - bi;
          ++bi;
        }
        const int bj = KIND == 0 ? rem : bi + rem;
        float d[2][4] = {};
        for (int k0 = 0; k0 < pp; k0 += 16) {
          unsigned a[4], bb[4];
          lda(a, rw, kLdP, 16 * bi, k0, lane);
          ldb_nk(bb, cl, kLdP, 16 * bj, k0, lane);
          mma(d[0], a, bb[0], bb[1]);
          mma(d[1], a, bb[2], bb[3]);
        }
        apply_decay<KIND == 0>(d, bi, bj, lcum, tR, tQ, tM, lane);
        float* blk = dgs + u * 256 + lane * 8;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float4 v = *reinterpret_cast<float4*>(blk + 4 * q);
          v.x += d[q][0];
          v.y += d[q][1];
          v.z += d[q][2];
          v.w += d[q][3];
          *reinterpret_cast<float4*>(blk + 4 * q) = v;
        }
      }
      if (!active) continue;
      // the row operand times the state's slice
      for (int k0 = 0; k0 < pp; k0 += 16) {
        unsigned a[4];
        lda(a, rw, kLdP, 16 * i, k0, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (2 * j < nt) {
            unsigned bh[4], bl[4];
            ldb_kn(bh, st_hi, kLdP, 16 * j, k0, lane);
            ldb_kn(bl, st_lo, kLdP, 16 * j, k0, lane);
            mma(ra[2 * j], a, bh[0], bh[1]);
            mma(ra[2 * j], a, bl[0], bl[1]);
            mma(ra[2 * j + 1], a, bh[2], bh[3]);
            mma(ra[2 * j + 1], a, bl[2], bl[3]);
          }
        }
      }
    }
    if (active) {
      const float sa = tS[16 * i + gr], sb = tS[16 * i + gr + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] = __fmaf_rn(sa, ra[j][0], acc[j][0]);
        acc[j][1] = __fmaf_rn(sa, ra[j][1], acc[j][1]);
        acc[j][2] = __fmaf_rn(sb, ra[j][2], acc[j][2]);
        acc[j][3] = __fmaf_rn(sb, ra[j][3], acc[j][3]);
      }
    }
  }
  __syncthreads();  // dG is whole
  if (!active) return;
  // out = acc + dG[i, :] Y (dG split into hi/lo A operands)
  for (int j = jlo; j <= jhi; ++j) {
    const float* blk = dgs + (first + j - jlo) * 256 + lane * 8;
    float v[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(blk + 4 * q);
      v[q][0] = f.x;
      v[q][1] = f.y;
      v[q][2] = f.z;
      v[q][3] = f.w;
    }
    unsigned ah[4], al[4];
    split_block(v, ah, al);
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      if (2 * jn < nt) {
        unsigned bb[4];
        ldb_kn(bb, ys, kLdP, 16 * jn, 16 * j, lane);
        mma(acc[2 * jn], ah, bb[0], bb[1]);
        mma(acc[2 * jn], al, bb[0], bb[1]);
        mma(acc[2 * jn + 1], ah, bb[2], bb[3]);
        mma(acc[2 * jn + 1], al, bb[2], bb[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * i + gr + 8 * hf, n = n0 + 8 * j + 2 * gc;
        if (r < L) {
          bf16* o = out + (row0 + r) * N + n;
          if (n + 1 < N && (N % 2) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(acc[j][2 * hf], acc[j][2 * hf + 1]);
          } else {
            if (n < N) o[0] = __float2bfloat16_rn(acc[j][2 * hf]);
            if (n + 1 < N) o[1] = __float2bfloat16_rn(acc[j][2 * hf + 1]);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
cross_mma(const bf16* __restrict__ x, const float* __restrict__ tabs, const bf16* __restrict__ Bm,
          const bf16* __restrict__ C, const float* __restrict__ states, const bf16* __restrict__ dy,
          const float* __restrict__ dstates, bf16* __restrict__ dB, bf16* __restrict__ dC, int T,
          int H, int P, int N, int L, CrossLayout g, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  if ((blockIdx.x & 1) == 0)  // the number of kinds x groups is even
    cross_body<0>(x, tabs, Bm, C, states, dy, dstates, dC, T, H, P, N, L, g, vec != 0, smem);
  else
    cross_body<1>(x, tabs, Bm, C, states, dy, dstates, dB, T, H, P, N, L, g, vec != 0, smem);
}

// -- float32: FP32 FMAs in the same grids --------------------------------------------------

// shared memory of the float32 launches, in floats
__host__ __device__ inline size_t local_fma_floats(int L) {
  const size_t gpart = 2 * (size_t)L * (kNG + 1);
  const size_t upart = (size_t)L * (kFP + 1) + (size_t)L * (kNG + 1) + round16(L) + (size_t)L;
  return gpart > upart ? gpart : upart;
}
__host__ __device__ inline size_t head_fma_floats(int L) {
  return (size_t)L * (L + 1) + 4 * (size_t)L * (kFP + 1) + 2 * (size_t)kFP * (kFN + 1) +
         3 * (size_t)L + 32 * (size_t)L + 4 * (size_t)L + kThreads;
}
__host__ __device__ inline size_t cross_fma_floats(int L) {
  return (size_t)L * (L + 1) + 2 * (size_t)L * (kFP + 1) + (size_t)kFP * (kNG + 1) +
         (size_t)L * (kNG + 1) + 2 * (size_t)L;
}

// 1. float32 local: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
__global__ void __launch_bounds__(kThreads)
local_fma(const float* __restrict__ dy, const float* __restrict__ loga,
          const float* __restrict__ Bm, const float* __restrict__ C,
          const float* __restrict__ dfinal, float* __restrict__ dstates,
          float* __restrict__ gram, float* __restrict__ tabs, int T, int H, int P, int N, int L,
          int lp) {
  extern __shared__ float fs[];
  const int h = blockIdx.x % (H + 1), c = blockIdx.x / (H + 1), b = blockIdx.y, nc = T / L;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row0 = (size_t)b * T + (size_t)c * L;
  constexpr int ldn = kNG + 1;
  if (h == H) {  // G^T[s, t] = B_s . C_t
    float* Bs = fs;
    float* Cs = Bs + L * ldn;
    float acc[8][8] = {};
    for (int n0 = 0; n0 < N; n0 += kNG) {
      const int nt = min(kNG, N - n0);
      for (int k = threadIdx.x; k < L * kNG; k += kThreads) {
        const int t = k / kNG, n = k - t * kNG;
        const bool ok = n < nt;
        Bs[t * ldn + n] = ok ? Bm[(row0 + t) * N + n0 + n] : 0.0f;
        Cs[t * ldn + n] = ok ? C[(row0 + t) * N + n0 + n] : 0.0f;
      }
      __syncthreads();
      for (int n = 0; n < nt; ++n) {
        float a[8], bb[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty + 16 * i, q = tx + 16 * i;
          a[i] = r < L ? Bs[r * ldn + n] : 0.0f;
          bb[i] = q < L ? Cs[q * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
    float* gt = gram + ((size_t)b * nc + c) * lp * lp;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = ty + 16 * i, t = tx + 16 * j;
        if (s < L && t < L) gt[(size_t)s * lp + t] = acc[i][j];
      }
    return;
  }
  float* ady = fs;                   // [L][kFP + 1] exp(l_t) dy_t, a p-tile
  float* Cs = ady + L * (kFP + 1);   // [L][ldn]
  float* lc = Cs + L * ldn;          // [lp]
  float* el = lc + lp;               // [L]
  cumsum_warp0(lc, loga, row0, H, h, L, lp);
  __syncthreads();
  write_tables(tabs + (((size_t)b * nc + c) * H + h) * tab_floats(lp), lc, L, lp);
  if (c == 0) {
    seed_last(dstates, dfinal, b, h, nc, H, P, N);
    return;
  }
  for (int t = threadIdx.x; t < L; t += kThreads) el[t] = expf(lc[t]);
  float* dst = dstates + (((size_t)b * nc + c - 1) * H + h) * P * N;
  for (int p0 = 0; p0 < P; p0 += kFP) {
    const int pw = min(kFP, P - p0);
    __syncthreads();
    for (int k = threadIdx.x; k < L * kFP; k += kThreads) {
      const int t = k / kFP, p = k - t * kFP;
      ady[t * (kFP + 1) + p] = p < pw ? el[t] * dy[((row0 + t) * H + h) * P + p0 + p] : 0.0f;
    }
    for (int n0 = 0; n0 < N; n0 += kNG) {
      const int nt = min(kNG, N - n0);
      for (int k = threadIdx.x; k < L * kNG; k += kThreads) {
        const int t = k / kNG, n = k - t * kNG;
        Cs[t * ldn + n] = n < nt ? C[(row0 + t) * N + n0 + n] : 0.0f;
      }
      __syncthreads();
      float acc[2][4] = {};
      for (int t = 0; t < L; ++t) {
        float a[2], bb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = ady[t * (kFP + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Cs[t * ldn + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], bb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = ty + 16 * i, n = tx + 16 * j;
          if (p < pw && n < nt) dst[(size_t)(p0 + p) * N + n0 + n] = acc[i][j];
        }
      __syncthreads();
    }
  }
}

// 3. float32 head: W^T in shared memory; Z, Y, dx per p-tile; D and A^T
__global__ void __launch_bounds__(kThreads)
head_fma(const float* __restrict__ x, const float* __restrict__ loga,
         const float* __restrict__ Bm, const float* __restrict__ C,
         const float* __restrict__ states, const float* __restrict__ dy,
         const float* __restrict__ dstates, const float* __restrict__ gram,
         float* __restrict__ dx, float* __restrict__ dloga, int T, int H, int P, int N, int L,
         int lp) {
  extern __shared__ float fs[];
  constexpr int ldp = kFP + 1, ldn = kFN + 1;
  const int h = blockIdx.x % H, c = blockIdx.x / H, b = blockIdx.y, nc = T / L;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row0 = (size_t)b * T + (size_t)c * L;
  float* W = fs;                      // [L][L + 1] W^T[s, t], t >= s
  float* xs = W + L * (L + 1);        // [L][ldp]
  float* dys = xs + L * ldp;          // [L][ldp]
  float* Bs = dys + L * ldp;          // [L][ldn]
  float* Cs = Bs + L * ldn;           // [L][ldn]
  float* Ss = Cs + L * ldn;           // [kFP][ldn]
  float* dSs = Ss + kFP * ldn;        // [kFP][ldn]
  float* lc = dSs + kFP * ldn;        // [L]
  float* el = lc + L;                 // [L]
  float* wout = el + L;               // [L]
  float* red = wout + L;              // [2][16][L] partials
  float* rsum = red + 32 * L;         // [L] sum_s A[t, s]
  float* csum = rsum + L;             // [L] sum_t A[t, s]
  float* xz = csum + L;               // [L]
  float* ry = xz + L;                 // [L]
  float* sdp = ry + L;                // [kThreads]
  for (int t = threadIdx.x; t < 4 * L; t += kThreads) rsum[t] = 0.0f;
  cumsum_warp0(lc, loga, row0, H, h, L, L);
  __syncthreads();
  const float ltot = lc[L - 1];
  for (int t = threadIdx.x; t < L; t += kThreads) {
    el[t] = expf(lc[t]);
    wout[t] = expf(ltot - lc[t]);
  }
  const float* gt = gram + ((size_t)b * nc + c) * lp * lp;
  for (int k = threadIdx.x; k < L * L; k += kThreads) {
    const int s = k / L, t = k - s * L;
    W[s * (L + 1) + t] = t >= s ? expf(lc[t] - lc[s]) * gt[(size_t)s * lp + t] : 0.0f;
  }
  const size_t sbase = (((size_t)b * nc + c) * H + h) * P * N;
  float sd = 0.0f;
  for (int p0 = 0; p0 < P; p0 += kFP) {
    const int pw = min(kFP, P - p0);
    __syncthreads();
    for (int k = threadIdx.x; k < L * kFP; k += kThreads) {
      const int t = k / kFP, p = k - t * kFP;
      const bool ok = p < pw;
      const size_t o = ((row0 + t) * H + h) * P + p0 + p;
      xs[t * ldp + p] = ok ? x[o] : 0.0f;
      dys[t * ldp + p] = ok ? dy[o] : 0.0f;
    }
    float z[8][2] = {}, yv[8][2] = {};  // rows r = ty + 16 i, columns p = tx + 16 j
    for (int n0 = 0; n0 < N; n0 += kFN) {
      const int nt = min(kFN, N - n0);
      __syncthreads();
      for (int k = threadIdx.x; k < L * kFN; k += kThreads) {
        const int t = k / kFN, n = k - t * kFN;
        const bool ok = n < nt;
        Bs[t * ldn + n] = ok ? Bm[(row0 + t) * N + n0 + n] : 0.0f;
        Cs[t * ldn + n] = ok ? C[(row0 + t) * N + n0 + n] : 0.0f;
      }
      for (int k = threadIdx.x; k < kFP * kFN; k += kThreads) {
        const int p = k / kFN, n = k - p * kFN;
        const bool ok = p < pw && n < nt;
        const size_t o = sbase + (size_t)(p0 + p) * N + n0 + n;
        const float sv = ok ? states[o] : 0.0f, dv = ok ? dstates[o] : 0.0f;
        Ss[p * ldn + n] = sv;
        dSs[p * ldn + n] = dv;
        sd = __fmaf_rn(dv, sv, sd);
      }
      __syncthreads();
      for (int n = 0; n < nt; ++n) {
        float sv[2], dv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sv[j] = Ss[(tx + 16 * j) * ldn + n];
          dv[j] = dSs[(tx + 16 * j) * ldn + n];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty + 16 * i;
          const float bv = r < L ? Bs[r * ldn + n] : 0.0f, cv = r < L ? Cs[r * ldn + n] : 0.0f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            z[i][j] = __fmaf_rn(bv, dv[j], z[i][j]);
            yv[i][j] = __fmaf_rn(cv, sv[j], yv[i][j]);
          }
        }
      }
    }
    // x_s . Z_s and dy_t . Y_t: this thread's columns, then over tx in order
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      if (r < L) {
        float a = 0.0f, d = 0.0f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a = __fmaf_rn(xs[r * ldp + tx + 16 * j], z[i][j], a);
          d = __fmaf_rn(dys[r * ldp + tx + 16 * j], yv[i][j], d);
        }
        red[tx * L + r] = a;
        red[(16 + tx) * L + r] = d;
      }
    }
    // dx = wout o Z + sum_{t >= s} W^T[s, t] dy_t
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = ty + 16 * i;
      if (s < L) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = tx + 16 * j;
          float acc = wout[s] * z[i][j];
          for (int t = s; t < L; ++t) acc = __fmaf_rn(W[s * (L + 1) + t], dys[t * ldp + p], acc);
          if (p < pw) dx[((row0 + s) * H + h) * P + p0 + p] = acc;
        }
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < L; r += kThreads) {
      float a = 0.0f, d = 0.0f;
      for (int k = 0; k < 16; ++k) {
        a += red[k * L + r];
        d += red[(16 + k) * L + r];
      }
      xz[r] += a;
      ry[r] += d;
    }
    __syncthreads();
    // D[t, s] = dy_t . x_s (this p-tile), A = W o D: row sums (t) and column sums (s)
    float D[8][8] = {};
    for (int p = 0; p < pw; ++p) {
      float a[8], bb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i, s = tx + 16 * i;
        a[i] = t < L ? dys[t * ldp + p] : 0.0f;
        bb[i] = s < L ? xs[s * ldp + p] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) D[i][j] = __fmaf_rn(a[i], bb[j], D[i][j]);
    }
    float rowp[8], colp[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) rowp[k] = colp[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        if (t < L && s <= t) {
          const float a = W[s * (L + 1) + t] * D[i][j];
          rowp[i] += a;
          colp[j] += a;
        }
      }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = ty + 16 * k, s = tx + 16 * k;
      if (t < L) red[tx * L + t] = rowp[k];
      if (s < L) red[(16 + ty) * L + s] = colp[k];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < L; r += kThreads) {
      float a = 0.0f, d = 0.0f;
      for (int k = 0; k < 16; ++k) {
        a += red[k * L + r];
        d += red[(16 + k) * L + r];
      }
      rsum[r] += a;
      csum[r] += d;
    }
  }
  sdp[threadIdx.x] = sd;
  __syncthreads();
  float last = 0.0f;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float s2 = 0.0f, f = 0.0f;
    for (int k = lane; k < kThreads; k += 32) s2 += sdp[k];
    for (int t = lane; t < L; t += 32) f = __fmaf_rn(wout[t], xz[t], f);
    last = __fmaf_rn(expf(ltot), warp_sum(s2), warp_sum(f));
  }
  reverse_cumsum_warp0(dloga, row0, H, h, L, [&](int t) {
    const float dl = rsum[t] - csum[t] + el[t] * ry[t] - wout[t] * xz[t];
    return t == L - 1 ? dl + last : dl;
  });
}

// 4. float32 cross: dG (dC, rows t) or dG^T (dB, rows s) in shared memory
// over the heads in order; the per-head products in registers
template <int KIND>
__device__ __forceinline__ void cross_fma_body(const float* __restrict__ x,
                                               const float* __restrict__ loga,
                                               const float* __restrict__ Bm,
                                               const float* __restrict__ C,
                                               const float* __restrict__ states,
                                               const float* __restrict__ dy,
                                               const float* __restrict__ dstates,
                                               float* __restrict__ out, int T, int H, int P,
                                               int N, int L, float* fs) {
  constexpr int ldp = kFP + 1, ldn = kNG + 1;
  const int kinds = 2 * ((N + kNG - 1) / kNG);
  const int ng = (blockIdx.x % kinds) >> 1, c = blockIdx.x / kinds, b = blockIdx.y, nc = T / L;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n0 = kNG * ng, nw = min(kNG, N - n0);
  const size_t row0 = (size_t)b * T + (size_t)c * L;
  float* dGs = fs;                   // [L][L + 1]
  float* rws = dGs + L * (L + 1);    // [L][ldp] the row operand
  float* cls = rws + L * ldp;        // [L][ldp] the column operand
  float* sts = cls + L * ldp;        // [kFP][ldn] the state's slice
  float* ys = sts + kFP * ldn;       // [L][ldn] the columns of B or C
  float* lc = ys + L * ldn;          // [L]
  float* tS = lc + L;                // [L] the row scale
  const float* rsrc = KIND == 0 ? dy : x;
  const float* csrc = KIND == 0 ? x : dy;
  const float* ssrc = KIND == 0 ? states : dstates;
  const float* ysrc = KIND == 0 ? Bm : C;
  for (int k = threadIdx.x; k < L * (L + 1); k += kThreads) dGs[k] = 0.0f;
  for (int k = threadIdx.x; k < L * kNG; k += kThreads) {
    const int t = k / kNG, n = k - t * kNG;
    ys[t * ldn + n] = n < nw ? ysrc[(row0 + t) * N + n0 + n] : 0.0f;
  }
  float acc[8][4] = {};  // rows r = ty + 16 i, columns n = tx + 16 j
  for (int h = 0; h < H; ++h) {
    __syncthreads();
    cumsum_warp0(lc, loga, row0, H, h, L, L);
    __syncthreads();
    const float ltot = lc[L - 1];
    for (int t = threadIdx.x; t < L; t += kThreads)
      tS[t] = KIND == 0 ? expf(lc[t]) : expf(ltot - lc[t]);
    const size_t sbase = (((size_t)b * nc + c) * H + h) * P * N;
    float ra[8][4] = {};
    for (int p0 = 0; p0 < P; p0 += kFP) {
      const int pw = min(kFP, P - p0);
      __syncthreads();
      for (int k = threadIdx.x; k < L * kFP; k += kThreads) {
        const int t = k / kFP, p = k - t * kFP;
        const bool ok = p < pw;
        const size_t o = ((row0 + t) * H + h) * P + p0 + p;
        rws[t * ldp + p] = ok ? rsrc[o] : 0.0f;
        cls[t * ldp + p] = ok ? csrc[o] : 0.0f;
      }
      for (int k = threadIdx.x; k < kFP * kNG; k += kThreads) {
        const int p = k / kNG, n = k - p * kNG;
        sts[p * ldn + n] = p < pw && n < nw ? ssrc[sbase + (size_t)(p0 + p) * N + n0 + n] : 0.0f;
      }
      __syncthreads();
      float D[8][8] = {};
      for (int p = 0; p < pw; ++p) {
        float a[8], bb[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty + 16 * i, q = tx + 16 * i;
          a[i] = r < L ? rws[r * ldp + p] : 0.0f;
          bb[i] = q < L ? cls[q * ldp + p] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) D[i][j] = __fmaf_rn(a[i], bb[j], D[i][j]);
        float sv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = sts[p * ldn + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ra[i][j] = __fmaf_rn(a[i], sv[j], ra[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = ty + 16 * i, q = tx + 16 * j;
          const int t = KIND == 0 ? r : q, s = KIND == 0 ? q : r;
          if (r < L && q < L && t >= s) dGs[r * (L + 1) + q] += expf(lc[t] - lc[s]) * D[i][j];
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      const float sc = r < L ? tS[r] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(sc, ra[i][j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= L) continue;
    const int qlo = KIND == 0 ? 0 : r, qhi = KIND == 0 ? r : L - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      float v = acc[i][j];
      for (int q = qlo; q <= qhi; ++q) v = __fmaf_rn(dGs[r * (L + 1) + q], ys[q * ldn + n], v);
      if (n < nw) out[(row0 + r) * N + n0 + n] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cross_fma(const float* __restrict__ x, const float* __restrict__ loga,
          const float* __restrict__ Bm, const float* __restrict__ C,
          const float* __restrict__ states, const float* __restrict__ dy,
          const float* __restrict__ dstates, float* __restrict__ dB, float* __restrict__ dC,
          int T, int H, int P, int N, int L) {
  extern __shared__ float fs[];
  if ((blockIdx.x & 1) == 0)
    cross_fma_body<0>(x, loga, Bm, C, states, dy, dstates, dC, T, H, P, N, L, fs);
  else
    cross_fma_body<1>(x, loga, Bm, C, states, dy, dstates, dB, T, H, P, N, L, fs);
}

// -- launching ---------------------------------------------------------------------------

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// shared memory of launch `which` (0 local, 1 pass, 2 head, 3 cross), bytes
size_t smem_bytes(int dtype, int which, int N, int L) {
  if (dtype == 0) {
    switch (which) {
      case 0: return 4 * local_fma_floats(L);
      case 2: return 4 * head_fma_floats(L);
      case 3: return 4 * cross_fma_floats(L);
      default: return 0;
    }
  }
  switch (which) {
    case 0: return (size_t)local_layout(L, N).total;
    case 2: return (size_t)head_layout(L).total;
    case 3: return (size_t)cross_layout(L).total;
    default: return 0;
  }
}

// the pass reads each chunk's decay exp(l_L) from its block of the tables
int launch_pass(const float* tabs, int L, float* dstates, int Bsz, int nc, int H, int P, int N,
                cudaStream_t st) {
  const int lp = round16(L), pn = P * N;
  const float* decay = tabs + 3 * lp + L - 1;
  const size_t per = (size_t)H * pn;
  if (pn % 4 == 0) {
    const dim3 grid((unsigned)((per / 4 + kThreads - 1) / kThreads), Bsz);
    pass_kernel<4><<<grid, kThreads, 0, st>>>(decay, tab_floats(lp), dstates, nc, H, pn);
  } else {
    const dim3 grid((unsigned)((per + kThreads - 1) / kThreads), Bsz);
    pass_kernel<1><<<grid, kThreads, 0, st>>>(decay, tab_floats(lp), dstates, nc, H, pn);
  }
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* x, const float* loga, const bf16* Bm, const bf16* C,
                const float* states, const bf16* dy, const float* dfinal, bf16* dx, float* dloga,
                bf16* dB, bf16* dC, float* gram, float* dstates, float* tabs, int Bsz, int T,
                int H, int P, int N, int L, cudaStream_t st) {
  const int nc = T / L;
  const LocalLayout g1 = local_layout(L, N);
  const HeadLayout g3 = head_layout(L);
  const CrossLayout g4 = cross_layout(L);
  if ((size_t)g1.total > kMaxSmem || (size_t)g3.total > kMaxSmem || (size_t)g4.total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = set_smem((const void*)local_mma, g1.total)) != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)head_mma, g3.total)) != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)cross_mma, g4.total)) != cudaSuccess) return (int)err;
  // 16-byte copies: rows of B, C and the x and dy slices are 16-byte multiples and aligned
  const int vec = N % 8 == 0 && P % 8 == 0 &&
                  ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)C | (uintptr_t)dy) % 16 == 0;
  local_mma<<<dim3((H + 1) * nc, Bsz), kThreads, g1.total, st>>>(dy, loga, Bm, C, dfinal, dstates,
                                                               gram, tabs, T, H, P, N, L, g1,
                                                               vec);
  int rc = launch_pass(tabs, L, dstates, Bsz, nc, H, P, N, st);
  if (rc != 0) return rc;
  head_mma<<<dim3(H * nc, Bsz), kThreads, g3.total, st>>>(x, tabs, Bm, C, states, dy, dstates,
                                                          gram, dx, dloga, T, H, P, N, L, g3,
                                                          vec);
  cross_mma<<<dim3(2 * ((N + kNG - 1) / kNG) * nc, Bsz), kThreads, g4.total, st>>>(
      x, tabs, Bm, C, states, dy, dstates, dB, dC, T, H, P, N, L, g4, vec);
  return (int)cudaGetLastError();
}

int launch_f32(const float* x, const float* loga, const float* Bm, const float* C,
               const float* states, const float* dy, const float* dfinal, float* dx,
               float* dloga, float* dB, float* dC, float* gram, float* dstates, float* tabs,
               int Bsz, int T, int H, int P, int N, int L, cudaStream_t st) {
  const int nc = T / L, lp = round16(L);
  const size_t s1 = smem_bytes(0, 0, N, L), s3 = smem_bytes(0, 2, N, L),
               s4 = smem_bytes(0, 3, N, L);
  if (s1 > kMaxSmem || s3 > kMaxSmem || s4 > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = set_smem((const void*)local_fma, s1)) != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)head_fma, s3)) != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)cross_fma, s4)) != cudaSuccess) return (int)err;
  local_fma<<<dim3((H + 1) * nc, Bsz), kThreads, s1, st>>>(dy, loga, Bm, C, dfinal, dstates, gram,
                                                         tabs, T, H, P, N, L, lp);
  int rc = launch_pass(tabs, L, dstates, Bsz, nc, H, P, N, st);
  if (rc != 0) return rc;
  head_fma<<<dim3(H * nc, Bsz), kThreads, s3, st>>>(x, loga, Bm, C, states, dy, dstates, gram,
                                                    dx, dloga, T, H, P, N, L, lp);
  cross_fma<<<dim3(2 * ((N + kNG - 1) / kNG) * nc, Bsz), kThreads, s4, st>>>(
      x, loga, Bm, C, states, dy, dstates, dB, dC, T, H, P, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one CTA of launch `which` (0 local, 1 pass, 2 head,
// 3 cross) for dtype code `dtype` (as below), in bytes; the wrapper's
// backward_plan mirrors it.
extern "C" long ssd_scan_bwd_smem(int dtype, int which, int N, int L) {
  if (N <= 0 || N > kMaxN || L <= 0 || L > kMaxChunk || dtype < 0 || dtype > 1) return 0;
  return (long)smem_bytes(dtype, which, N, L);
}

// dtype code (x, B, C, dy, dx, dB and dC): 0 = float32, 1 = bfloat16; loga,
// the saved states (B, nc, H, P, N), the final state's gradient (B, H, P, N;
// null for zero), dloga and the scratch (gram: G^T (B, nc, Lp, Lp) with Lp =
// L rounded up to 16; dstates like the states; tabs (B, nc, H, 5 Lp + 64),
// each chunk and head's decay tables) are float32.  Returns a cudaError_t (0 = success); 1 (cudaErrorInvalidValue)
// for shapes the kernels do not take.
extern "C" int ssd_scan_bwd(int dtype, const void* x, const float* loga, const void* Bm,
                            const void* C, const float* states, const void* dy,
                            const float* dfinal, void* dx, float* dloga, void* dB, void* dC,
                            float* gram, float* dstates, float* tabs, int Bsz, int Tlen, int H,
                            int P, int N, int L, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || H <= 0 || H > 65535 || P <= 0 || N <= 0 || N > kMaxN ||
      L <= 0 || L > kMaxChunk || Tlen <= 0 || Tlen % L != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), loga, static_cast<const float*>(Bm),
                      static_cast<const float*>(C), states, static_cast<const float*>(dy), dfinal,
                      static_cast<float*>(dx), dloga, static_cast<float*>(dB),
                      static_cast<float*>(dC), gram, dstates, tabs, Bsz, Tlen, H, P, N, L, st);
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(x), loga, static_cast<const bf16*>(Bm),
                       static_cast<const bf16*>(C), states, static_cast<const bf16*>(dy), dfinal,
                       static_cast<bf16*>(dx), dloga, static_cast<bf16*>(dB),
                       static_cast<bf16*>(dC), gram, dstates, tabs, Bsz, Tlen, H, P, N, L, st);
  return (int)cudaErrorInvalidValue;
}
