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
// What bounds it: at the serve shape (B 1, T 1024, H 32, P 64, N 128, L 128,
// bf16) it moves 10.09 MB (3.0 us at 3.35 TB/s) and does 1.64 GFLOP of chunk
// products (1.7 us on the bf16 tensor cores), so bytes bound it once the
// products run on the tensor cores; on the FP32 pipes the same products
// take at least 24.5 us.  What held the first version back: one CTA per
// (head, row) — 32 CTAs on 132 SMs at batch 1 — scalar FP32 products, C.B
// recomputed per head with a shuffle reduction per (t, s), and no overlap
// of the chunk's loads with compute.
//
// Design (bfloat16, the served type):
// * grid (ceil(P/16), H, B): each CTA owns 16 state rows p of one head and
//   row and walks the chunks in order.  The split is exact — y[t, p] and
//   S[p, :] depend only on column p of x — and gives 128 CTAs at batch 1;
// * all four chunk products on the tensor cores (mma.sync m16n8k16, bf16 in,
//   f32 accumulate), L padded to a multiple of 16 with zero rows (masked on
//   store), as units of work spread evenly over 16 warps:
//     one unit per 16x16 block (t-block tb, s-block jj <= tb): G = C B^T in
//     registers, W = G o exp(l_t - l_s) converted in registers into the A
//     operand of W x[jj] (the accumulator layout of two n8 tiles is the A
//     layout of one k16 step), stored as a partial y block;
//     one unit per t-block: y_inter = exp(l_t) C S^T, stored as a block;
//     dS = (x o wout)^T B, each warp its own n8 tiles of the state, which
//     stay in f32 registers from chunk to chunk (S <- exp(l_L) S + dS);
//   y is the partial blocks summed in s-block order (a fixed order: a call
//   is deterministic), done by 15 warps while the 16th takes the next
//   chunk's cumsum.  One t-block per warp left the warp of the last block
//   eight times the first's products;
// * the decay without an exp per element: below the diagonal 16x16 block,
//   exp(l_t - l_s) = R[t] M[tb][jj] Q[s], three per-chunk tables whose
//   factors are each <= 1 (no overflow, no underflow while the product is a
//   normal float); on the diagonal block exp(l_t - l_s) for s <= t only, so
//   no inf ever meets a masked zero;
// * precision: x, B and C are bf16 already and go in once.  W, x o wout and
//   the f32 state S are f32 values; one bf16 rounding of any of them costs
//   about 2^-9 relative, ten times the state limit, so each is split into a
//   hi and a lo bf16 part (hi = bf16(v), lo = bf16(v - hi)) and goes in as
//   two MMAs into one f32 accumulator: 2^-17 relative.  Conversions come in
//   packed pairs (the conversion pipe, not the tensor cores, bounded an
//   earlier version), and x o wout is split once per chunk into shared
//   memory for every warp's dS;
// * the chunk's B, C, x slice and log-decays are staged in shared memory by
//   cp.async (16-byte copies where rows are 16-byte multiples), the next
//   chunk's while this one computes (two stages where they fit, N <= 128 at
//   L 128); B and C are the same for every head, so the 32 heads' CTAs share
//   them through L2.  Rows are padded by 8 elements so that ldmatrix reads
//   8 rows from 8 distinct bank groups;
// * one launch per call; no host read, no atomics: capturable in a graph.
// What still holds it back: mma.sync issues at a fraction of the tensor
// cores' warpgroup (wgmma) rate and the units' ldmatrix traffic is of the
// same order, while G is computed again by each of a row's H * P/16 CTAs
// (with the hi/lo pairs the products do several times the useful flops);
// wgmma with a producer warp, and G shared across a row's heads, are the
// next steps.
// float32 keeps FP32 FMAs (exact fused multiply-adds, W's lower triangle,
// the state transposed in shared memory) in the same grid: a bf16 split of
// f32 inputs would need three products per term to meet the f32 limit.
// L <= 128 (the model passes min(128, T), the smoke configs 8), N <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the float32 kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMmaThreads = 512;  // the bfloat16 kernel: 16 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kPB = 16;  // state rows p per CTA
constexpr int kMaxChunk = 128;
constexpr int kMaxN = 256;
constexpr int kXStride = kPB + 8;  // bf16 elements per staged x row
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// -- bfloat16: shared-memory layout (byte offsets) ------------------------------
struct Layout {
  int lp, np;       // L and N padded to multiples of 16
  int ldc;          // row stride of C, B and the state halves (np + 8)
  int stages;       // 2: the next chunk loads while this one computes
  int stage_bytes;  // one stage: C, B, x, log-decays
  int off_b, off_x, off_la;  // within a stage
  int off_s;        // the state, hi/lo for two chunks: [4][16][ldc]
  int off_xw;       // x o wout transposed, hi then lo: [16][lp + 8] bf16 each
  int off_lcum;     // [lp] f32
  int off_tab;      // decay factors, f32: R [lp], Q [lp], E [lp], M [8][8]
  int off_part;     // y partials, f32 16x16 blocks: W x per (t-block, s-block <= it),
                    // then C S^T per t-block
  int total;
};

__host__ __device__ inline Layout make_layout(int L, int N, int stages) {
  Layout g;
  g.lp = round16(L);
  g.np = round16(N);
  g.ldc = g.np + 8;
  g.stages = stages;
  const int cb = g.lp * g.ldc * 2;
  g.off_b = cb;
  g.off_x = 2 * cb;
  g.off_la = g.off_x + g.lp * kXStride * 2;
  g.stage_bytes = g.off_la + g.lp * 4;
  g.off_s = stages * g.stage_bytes;
  g.off_xw = g.off_s + 4 * kPB * g.ldc * 2;
  g.off_lcum = g.off_xw + 2 * kPB * (g.lp + 8) * 2;
  g.off_tab = g.off_lcum + g.lp * 4;
  g.off_part = g.off_tab + 3 * g.lp * 4 + 64 * 4;
  const int nb = g.lp / 16;
  g.total = g.off_part + (nb * (nb + 1) / 2 + nb) * 256 * 4;
  return g;
}

inline Layout pick_layout(int L, int N) {
  Layout two = make_layout(L, N, 2);
  return (size_t)two.total <= kMaxSmem ? two : make_layout(L, N, 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
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

__device__ __forceinline__ void ldsm_x2_t(unsigned r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// Stage chunk c0's C, B (rows < L, cols < N), x[:, h, p0:p0+16] and
// log-decays; padded rows and columns keep the zeros written at start.
__device__ void load_chunk(unsigned char* stage, const Layout& g, const __nv_bfloat16* x,
                           const float* loga, const __nv_bfloat16* Bm,
                           const __nv_bfloat16* C, int b, int c0, int T, int H, int P,
                           int N, int L, int h, int p0, bool vec) {
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(stage + g.off_b);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + g.off_x);
  float* la = reinterpret_cast<float*>(stage + g.off_la);
  const size_t row0 = (size_t)b * T + c0;
  const int pw = min(kPB, P - p0);
  if (vec) {
    // a thread keeps one 16-byte column segment and walks the rows
    const int segs = N / 8, rows = kMmaThreads / segs;
    if (threadIdx.x < rows * segs) {
      const int j = (threadIdx.x % segs) * 8;
      for (int t = threadIdx.x / segs; t < L; t += rows) {
        cp_async16(cs + t * g.ldc + j, C + (row0 + t) * N + j);
        cp_async16(bs + t * g.ldc + j, Bm + (row0 + t) * N + j);
      }
    }
    const int xsegs = (pw + 7) / 8;  // P % 8 == 0 here
    const int xrows = kMmaThreads / xsegs;
    if (threadIdx.x < xrows * xsegs) {
      const int j = (threadIdx.x % xsegs) * 8;
      for (int t = threadIdx.x / xsegs; t < L; t += xrows) {
        cp_async16(xs + t * kXStride + j, x + ((row0 + t) * H + h) * P + p0 + j);
      }
    }
  } else {
    for (int i = threadIdx.x; i < L * N; i += kMmaThreads) {
      const int t = i / N, j = i - t * N;
      cs[t * g.ldc + j] = C[(row0 + t) * N + j];
      bs[t * g.ldc + j] = Bm[(row0 + t) * N + j];
    }
    for (int i = threadIdx.x; i < L * pw; i += kMmaThreads) {
      const int t = i / pw, j = i - t * pw;
      xs[t * kXStride + j] = x[((row0 + t) * H + h) * P + p0 + j];
    }
  }
  for (int t = threadIdx.x; t < L; t += kMmaThreads) cp_async4(la + t, loga + (row0 + t) * H + h);
  cp_commit();
}

// One chunk's shared operands, as a warp's work reads them.
struct Chunk {
  const __nv_bfloat16 *cs, *bs, *xs;  // staged C, B [lp][ldc]; x [lp][kXStride]
  const __nv_bfloat16 *s_hi, *s_lo;   // the state entering the chunk [16][ldc]
  const __nv_bfloat16 *xw_hi, *xw_lo; // (x o wout)^T split [16][lp + 8]
  const float *lcum, *tR, *tQ, *tE, *tM;
  int ldc, np;
};

// A 16x16 f32 accumulator pair (two n8 tiles) stored as a row-major block.
__device__ __forceinline__ void store_block(float* blk, const float (&acc)[2][4], int lane) {
  const int gr = lane / 4, gc = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *reinterpret_cast<float2*>(blk + gr * 16 + 8 * j + 2 * gc) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(blk + (gr + 8) * 16 + 8 * j + 2 * gc) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// One unit of a chunk's y work: the 16x16 block (tb, jj) of G = C B^T
// (jj <= tb), W = G o decay split into hi/lo A operands, and its part of
// y_intra, W x[jj], stored as a partial block.
__device__ __forceinline__ void y_unit(const Chunk& k, int tb, int jj, int lane, float* part) {
  const int gr = lane / 4, gc = lane % 4;
  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int srow = (lane % 8) + (lane / 16) * 8, scol = ((lane / 8) % 2) * 8;
  const __nv_bfloat16* arow = k.cs + (16 * tb + (lane % 16)) * k.ldc + (lane / 16) * 8;
  const __nv_bfloat16* brow = k.bs + (16 * jj + srow) * k.ldc + scol;
#pragma unroll 4
  for (int kk = 0; kk < k.np / 16; ++kk) {
    unsigned a[4], bb[4];
    ldsm_x4(a, arow + 16 * kk);
    ldsm_x4(bb, brow + 16 * kk);
    mma(acc[0], a, bb[0], bb[1]);
    mma(acc[1], a, bb[2], bb[3]);
  }
  const int ta = 16 * tb + gr, tb8 = ta + 8;
  float w[2][4];
  if (jj < tb) {  // below the diagonal block: the factored decay
    const float m = k.tM[8 * tb + jj], fa = k.tR[ta] * m, fb = k.tR[tb8] * m;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 8 * (2 * jj + q) + 2 * gc + (e & 1);
        w[q][e] = acc[q][e] * (e < 2 ? fa : fb) * k.tQ[s];
      }
    }
  } else {  // the diagonal block: exp(l_t - l_s) for s <= t only
    const float la_ = k.lcum[ta], lb_ = k.lcum[tb8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 8 * (2 * jj + q) + 2 * gc + (e & 1);
        const int t = e < 2 ? ta : tb8;
        w[q][e] = s <= t ? acc[q][e] * expf((e < 2 ? la_ : lb_) - k.lcum[s]) : 0.0f;
      }
    }
  }
  unsigned ah[4], al[4];
  split2(w[0][0], w[0][1], ah[0], al[0]);
  split2(w[0][2], w[0][3], ah[1], al[1]);
  split2(w[1][0], w[1][1], ah[2], al[2]);
  split2(w[1][2], w[1][3], ah[3], al[3]);
  unsigned bx[4];
  ldsm_x4_t(bx, k.xs + (16 * jj + (lane % 8) + ((lane / 8) % 2) * 8) * kXStride +
                    (lane / 16) * 8);
  float ya[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ya[j][e] = 0.0f;
  mma(ya[0], ah, bx[0], bx[1]);
  mma(ya[0], al, bx[0], bx[1]);
  mma(ya[1], ah, bx[2], bx[3]);
  mma(ya[1], al, bx[2], bx[3]);
  store_block(part, ya, lane);
}

// The other unit of y work: y_inter = exp(l_t) C S^T for t-block tb (the
// state's hi and lo halves), stored as a block.
__device__ __forceinline__ void yi_unit(const Chunk& k, int tb, int lane, float* part) {
  float yi[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yi[j][e] = 0.0f;
  const int srow = (lane % 8) + (lane / 16) * 8, scol = ((lane / 8) % 2) * 8;
  const __nv_bfloat16* arow = k.cs + (16 * tb + (lane % 16)) * k.ldc + (lane / 16) * 8;
#pragma unroll 4
  for (int kk = 0; kk < k.np / 16; ++kk) {
    unsigned a[4], bh[4], bl[4];
    ldsm_x4(a, arow + 16 * kk);
    ldsm_x4(bh, k.s_hi + srow * k.ldc + 16 * kk + scol);
    ldsm_x4(bl, k.s_lo + srow * k.ldc + 16 * kk + scol);
    mma(yi[0], a, bh[0], bh[1]);
    mma(yi[0], a, bl[0], bl[1]);
    mma(yi[1], a, bh[2], bh[3]);
    mma(yi[1], a, bl[2], bl[3]);
  }
  const float ea = k.tE[16 * tb + lane / 4], eb = k.tE[16 * tb + lane / 4 + 8];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    yi[j][0] *= ea;
    yi[j][1] *= ea;
    yi[j][2] *= eb;
    yi[j][3] *= eb;
  }
  store_block(part, yi, lane);
}

// y of one chunk from its partial blocks: the W x blocks of each t-block
// summed in s-block order, plus exp(l_t) C S^T; threads `first` onwards,
// `stride` apart, two p columns each.
__device__ __forceinline__ void sum_y(const float* part, int nunits, __nv_bfloat16* y,
                                      size_t yrow0, int H, int h, int P, int p0, int L,
                                      int first, int stride) {
  const float* part_yi = part + nunits * 256;
  for (int i = first; i < L * kPB / 2; i += stride) {
    const int t = i / (kPB / 2), pp = 2 * (i - t * (kPB / 2));
    const int tb = t / 16, r = t - 16 * tb;
    const float* blk = part + (tb * (tb + 1) / 2) * 256 + r * 16 + pp;
    float2 sum = make_float2(0.0f, 0.0f);
    for (int jj = 0; jj <= tb; ++jj) {
      const float2 v = *reinterpret_cast<const float2*>(blk + jj * 256);
      sum.x += v.x;
      sum.y += v.y;
    }
    const float2 yi = *reinterpret_cast<const float2*>(part_yi + tb * 256 + r * 16 + pp);
    const __nv_bfloat162 v = __floats2bfloat162_rn(sum.x + yi.x, sum.y + yi.y);
    __nv_bfloat16* dst = y + ((yrow0 + t) * H + h) * P + p0 + pp;
    if (p0 + pp + 1 < P && (P % 2) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = v;
    } else {
      if (p0 + pp < P) dst[0] = __low2bfloat16(v);
      if (p0 + pp + 1 < P) dst[1] = __high2bfloat16(v);
    }
  }
}

// dS = (x o wout)^T B into NI of the state's n8 tiles (warp, warp + 16, ...),
// S <- exp(l_L) S + dS, then the new state's hi/lo halves for the next chunk.
template <int NI>
__device__ __forceinline__ void ds_tiles(float (&sacc)[2][4], const Chunk& k, int warp, int lane,
                                         int lp, float etot, __nv_bfloat16* n_hi,
                                         __nv_bfloat16* n_lo) {
  const int gr = lane / 4, gc = lane % 4;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[i][e] *= etot;
  const int ldw = lp + 8;
  for (int ks = 0; ks < lp / 16; ++ks) {
    unsigned ah[4], al[4];
    ldsm_x4(ah, k.xw_hi + (lane % 16) * ldw + 16 * ks + (lane / 16) * 8);
    ldsm_x4(al, k.xw_lo + (lane % 16) * ldw + 16 * ks + (lane / 16) * 8);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      unsigned bb[2];
      ldsm_x2_t(bb, k.bs + (16 * ks + (lane % 8) + ((lane / 8) % 2) * 8) * k.ldc +
                        8 * (warp + kMmaWarps * i));
      mma(sacc[i], ah, bb[0], bb[1]);
      mma(sacc[i], al, bb[0], bb[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int n = 8 * (warp + kMmaWarps * i) + 2 * gc;
    unsigned hi, lo;
    split2(sacc[i][0], sacc[i][1], hi, lo);
    *reinterpret_cast<unsigned*>(n_hi + gr * k.ldc + n) = hi;
    *reinterpret_cast<unsigned*>(n_lo + gr * k.ldc + n) = lo;
    split2(sacc[i][2], sacc[i][3], hi, lo);
    *reinterpret_cast<unsigned*>(n_hi + (gr + 8) * k.ldc + n) = hi;
    *reinterpret_cast<unsigned*>(n_lo + (gr + 8) * k.ldc + n) = lo;
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_scan_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ loga,
                    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ C,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ state_out,
                    float* __restrict__ states, int T, int H, int P, int N, int L, Layout g,
                    int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, gc = lane % 4;  // the accumulator fragment's row and column pair
  __nv_bfloat16* sbuf = reinterpret_cast<__nv_bfloat16*>(smem + g.off_s);
  float* lcum = reinterpret_cast<float*>(smem + g.off_lcum);
  // with a_b = lcum[16 b + 15], the last log-decay of t-block b, and t in
  // block tb > jj >= blk(s): exp(l_t - l_s) = R[t] M[tb][jj] Q[s], each
  // factor <= 1 (no overflow, and none underflows while their product is
  // a normal float)
  float* tR = reinterpret_cast<float*>(smem + g.off_tab);  // exp(l_t - a_{blk(t)-1})
  float* tQ = tR + g.lp;                                   // exp(a_{blk(s)} - l_s)
  float* tE = tQ + g.lp;                                   // exp(l_t)
  float* tM = tE + g.lp;                                   // exp(a_{tb-1} - a_jj), jj < tb
  __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(smem + g.off_xw);
  const int ldw = g.lp + 8;
  float* part = reinterpret_cast<float*>(smem + g.off_part);
  const int nc = T / L;
  const int nb = g.lp / 16;               // t-blocks
  const int nunits = nb * (nb + 1) / 2;   // (t-block, s-block <= it) pairs
  float* part_yi = part + nunits * 256;   // exp(l_t) C S^T per t-block
  const int ntiles = g.np / 8;  // n8 tiles of the state
  // this warp's n8 tiles of the state: warp, warp + 16, ... below ntiles
  const int nmine = warp < ntiles ? (ntiles - warp + kMmaWarps - 1) / kMmaWarps : 0;

  // zeros: padded rows and columns of every stage, the initial state
  for (int i = threadIdx.x * 16; i < g.total; i += kMmaThreads * 16) {
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_chunk(smem, g, x, loga, Bm, C, b, 0, T, H, P, N, L, h, p0, vec);

  // this warp's slice of the state (f32, the accumulator layout: rows
  // p = gr, gr + 8; columns n = 8 nt + 2 gc, + 1)
  float sacc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[i][e] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    unsigned char* stage = smem + (g.stages == 2 ? (c & 1) : 0) * g.stage_bytes;
    Chunk k;
    k.cs = reinterpret_cast<const __nv_bfloat16*>(stage);
    k.bs = reinterpret_cast<const __nv_bfloat16*>(stage + g.off_b);
    k.xs = reinterpret_cast<const __nv_bfloat16*>(stage + g.off_x);
    k.s_hi = sbuf + (c & 1) * 2 * kPB * g.ldc;
    k.s_lo = k.s_hi + kPB * g.ldc;
    k.xw_hi = xw;
    k.xw_lo = xw + kPB * ldw;
    k.lcum = lcum;
    k.tR = tR;
    k.tQ = tQ;
    k.tE = tE;
    k.tM = tM;
    k.ldc = g.ldc;
    k.np = g.np;
    const float* la = reinterpret_cast<const float*>(stage + g.off_la);
    __nv_bfloat16* n_hi = sbuf + ((c + 1) & 1) * 2 * kPB * g.ldc;
    __nv_bfloat16* n_lo = n_hi + kPB * g.ldc;

    cp_wait_all();
    __syncthreads();  // chunk c staged; chunk c-1 done by every warp
    if (g.stages == 2 && c + 1 < nc) {
      load_chunk(smem + ((c + 1) & 1) * g.stage_bytes, g, x, loga, Bm, C, b, (c + 1) * L, T,
                 H, P, N, L, h, p0, vec);
    }
    if (warp > 0 && c > 0) {  // chunk c-1's y, beside chunk c's cumsum
      sum_y(part, nunits, y, (size_t)b * T + (size_t)(c - 1) * L, H, h, P, p0, L,
            threadIdx.x - 32, kMmaThreads - 32);
    }
    if (warp == 0) {  // inclusive cumsum of the log-decays, 4 per lane (padded rows add 0)
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = lane * 4 + i;
        run += t < g.lp ? la[t] : 0.0f;
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
        if (t < g.lp) lcum[t] = v[i] + excl;
      }
    }
    __syncthreads();
    const float ltot = lcum[L - 1];
    for (int t = threadIdx.x; t < g.lp; t += kMmaThreads) {
      const int blk = t / 16;
      tR[t] = blk > 0 ? expf(lcum[t] - lcum[16 * blk - 1]) : 1.0f;
      tQ[t] = expf(lcum[16 * blk + 15] - lcum[t]);
      tE[t] = expf(lcum[t]);
    }
    // (x o wout)^T, split once for every warp's dS: [p][s], s in pairs
    for (int i = threadIdx.x; i < kPB * g.lp / 2; i += kMmaThreads) {
      const int p = i % kPB, s2 = 2 * (i / kPB);
      const float v0 = __bfloat162float(k.xs[s2 * kXStride + p]) * expf(ltot - lcum[s2]);
      const float v1 = __bfloat162float(k.xs[(s2 + 1) * kXStride + p]) * expf(ltot - lcum[s2 + 1]);
      unsigned hi, lo;
      split2(v0, v1, hi, lo);
      *reinterpret_cast<unsigned*>(xw + p * ldw + s2) = hi;
      *reinterpret_cast<unsigned*>(xw + (kPB + p) * ldw + s2) = lo;
    }
    if (threadIdx.x < 64) {
      const int i = threadIdx.x / 8, jb = threadIdx.x % 8;
      tM[threadIdx.x] = jb < i && 16 * i < g.lp ? expf(lcum[16 * i - 1] - lcum[16 * jb + 15]) : 0.0f;
    }
    __syncthreads();

    if (states) {  // the state entering chunk c, for the backward pass
      float* sc = states + (((size_t)b * nc + c) * H + h) * P * N;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i < nmine) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = p0 + gr + (e < 2 ? 0 : 8);
            const int n = 8 * (warp + kMmaWarps * i) + 2 * gc + (e & 1);
            if (p < P && n < N) sc[(size_t)p * N + n] = sacc[i][e];
          }
        }
      }
    }
    // ---- the flow-out facet first: S <- exp(l_L) S + (x o wout)^T B, this
    // warp's n-tiles (they stay with the warp from chunk to chunk)
    const float etot = expf(ltot);
    switch (nmine) {
      case 0: break;
      case 1: ds_tiles<1>(sacc, k, warp, lane, g.lp, etot, n_hi, n_lo); break;
      default: ds_tiles<2>(sacc, k, warp, lane, g.lp, etot, n_hi, n_lo); break;
    }
    // ---- then the y units, spread evenly over the warps: every (t-block,
    // s-block <= it) pair, and C S^T per t-block
    for (int u = warp; u < nunits + nb; u += kMmaWarps) {
      if (u < nunits) {
        int tb = 0;
        while ((tb + 1) * (tb + 2) / 2 <= u) ++tb;
        y_unit(k, tb, u - tb * (tb + 1) / 2, lane, part + u * 256);
      } else {
        yi_unit(k, u - nunits, lane, part_yi + (u - nunits) * 256);
      }
    }
    // (y of this chunk is summed from its partial blocks at the next chunk's
    // start, or after the last chunk)
    if (g.stages == 1 && c + 1 < nc) {
      __syncthreads();  // every warp is done with the one stage
      load_chunk(smem, g, x, loga, Bm, C, b, (c + 1) * L, T, H, P, N, L, h, p0, vec);
    }
  }
  __syncthreads();
  sum_y(part, nunits, y, (size_t)b * T + (size_t)(nc - 1) * L, H, h, P, p0, L, threadIdx.x,
        kMmaThreads);

  float* so = state_out + ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int nt = warp + kMmaWarps * i;
    if (i < nmine) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gr + (e < 2 ? 0 : 8), n = 8 * nt + 2 * gc + (e & 1);
        if (p < P && n < N) so[(size_t)p * N + n] = sacc[i][e];
      }
    }
  }
}

// -- float32: FP32 FMAs in the same grid ---------------------------------------
size_t fma_smem_bytes(int N, int L) {
  return sizeof(float) * ((size_t)N * kPB + (size_t)L * kPB + (size_t)L * L + 3 * (size_t)L);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_fma_kernel(const float* __restrict__ x, const float* __restrict__ loga,
                    const float* __restrict__ Bm, const float* __restrict__ C,
                    float* __restrict__ y, float* __restrict__ state_out,
                    float* __restrict__ states, int T, int H, int P, int N, int L) {
  extern __shared__ float fsm[];
  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(kPB, P - p0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* St = fsm;              // [N][16] this CTA's state rows, transposed
  float* xs = St + N * kPB;     // [L][16] the chunk's x columns
  float* W = xs + L * kPB;      // [L][L] exp(l_t - l_s) C_t.B_s, s <= t
  float* lcum = W + L * L;      // [L]
  float* el = lcum + L;         // [L] exp(l_t)
  float* wout = el + L;         // [L] exp(l_L - l_s)
  const size_t row = (size_t)H * P;
  const float* xb = x + (size_t)b * T * row + (size_t)h * P + p0;
  float* yb = y + (size_t)b * T * row + (size_t)h * P + p0;
  const float* lb = loga + (size_t)b * T * H + h;
  const float* Bb = Bm + (size_t)b * T * N;
  const float* Cb = C + (size_t)b * T * N;

  for (int i = threadIdx.x; i < N * kPB; i += kThreads) St[i] = 0.0f;
  for (int c0 = 0; c0 < T; c0 += L) {
    if (states) {  // the state entering this chunk, for the backward pass
      __syncthreads();
      float* sc = states + (((size_t)b * (T / L) + c0 / L) * H + h) * P * N + (size_t)p0 * N;
      for (int i = threadIdx.x; i < pw * N; i += kThreads) {
        const int p = i / N, n = i - p * N;
        sc[i] = St[n * kPB + p];
      }
    }
    for (int i = threadIdx.x; i < L * kPB; i += kThreads) {
      const int t = i / kPB, p = i - t * kPB;
      xs[i] = p < pw ? xb[(size_t)(c0 + t) * row + p] : 0.0f;
    }
    for (int t = threadIdx.x; t < L; t += kThreads) lcum[t] = lb[(size_t)(c0 + t) * H];
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
    // intra-chunk weights, lower triangle only: one warp per t, lanes along n
    for (int t = warp; t < L; t += kWarps) {
      const float* ct = Cb + (size_t)(c0 + t) * N;
      for (int s = 0; s <= t; ++s) {
        const float* bs = Bb + (size_t)(c0 + s) * N;
        float gsum = 0.0f;
        for (int n = lane; n < N; n += 32) gsum = __fmaf_rn(ct[n], bs[n], gsum);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
        if (lane == 0) W[t * L + s] = expf(lcum[t] - lcum[s]) * gsum;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < L * kPB; i += kThreads) {
      const int t = i / kPB, p = i - t * kPB;
      float intra = 0.0f;
      const float* wt = W + t * L;
      for (int s = 0; s <= t; ++s) intra = __fmaf_rn(wt[s], xs[s * kPB + p], intra);
      const float* ct = Cb + (size_t)(c0 + t) * N;
      float cs = 0.0f;
      for (int n = 0; n < N; ++n) cs = __fmaf_rn(ct[n], St[n * kPB + p], cs);
      if (p < pw) yb[(size_t)(c0 + t) * row + p] = __fmaf_rn(el[t], cs, intra);
    }
    __syncthreads();
    const float etot = expf(ltot);
    for (int i = threadIdx.x; i < N * kPB; i += kThreads) {
      const int n = i / kPB, p = i - n * kPB;
      const float* bn = Bb + (size_t)c0 * N + n;
      float ds = 0.0f;
      for (int s = 0; s < L; ++s) ds = __fmaf_rn(xs[s * kPB + p] * wout[s], bn[(size_t)s * N], ds);
      St[i] = __fmaf_rn(etot, St[i], ds);
    }
    __syncthreads();
  }
  float* so = state_out + ((size_t)b * H + h) * P * N + (size_t)p0 * N;
  for (int i = threadIdx.x; i < pw * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    so[i] = St[n * kPB + p];
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Shared memory one CTA of the launch uses, in bytes (dtype code as below;
// 0 for shapes the kernel does not take).  The wrapper's launch_plan mirrors
// it.
extern "C" long ssd_scan_smem(int dtype, int N, int L) {
  if (N <= 0 || N > kMaxN || L <= 0 || L > kMaxChunk) return 0;
  if (dtype == 0) return (long)fma_smem_bytes(N, L);
  if (dtype == 1) return (long)pick_layout(L, N).total;
  return 0;
}

// dtype code (x, B, C and y): 0 = float32, 1 = bfloat16; loga, the state
// and `states` are float32.  `states` (B, T/L, H, P, N), when not null,
// receives the state entering every chunk (the backward pass reads them);
// the serving path passes null.
// Returns a cudaError_t (0 = success); 1 (cudaErrorInvalidValue) for shapes
// the kernel does not take.
extern "C" int ssd_scan(int dtype, const void* x, const float* loga, const void* Bm,
                        const void* C, void* y, float* state, float* states, int Bsz, int Tlen,
                        int H, int P, int N, int L, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || H <= 0 || H > 65535 || P <= 0 || N <= 0 || N > kMaxN ||
      L <= 0 || L > kMaxChunk || Tlen <= 0 || Tlen % L != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((P + kPB - 1) / kPB, H, Bsz);
  if (dtype == 0) {
    const size_t smem = fma_smem_bytes(N, L);
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem((const void*)ssd_scan_fma_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ssd_scan_fma_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), loga, static_cast<const float*>(Bm),
        static_cast<const float*>(C), static_cast<float*>(y), state, states, Tlen, H, P, N, L);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    const Layout g = pick_layout(L, N);
    if ((size_t)g.total > kMaxSmem) return (int)cudaErrorInvalidValue;
    // 16-byte copies: rows of B, C and the x slice are 16-byte multiples and aligned
    const bool vec = N % 8 == 0 && P % 8 == 0 &&
                     ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)C) % 16 == 0;
    cudaError_t err = set_smem((const void*)ssd_scan_mma_kernel, g.total);
    if (err != cudaSuccess) return (int)err;
    ssd_scan_mma_kernel<<<grid, kMmaThreads, g.total, st>>>(
        static_cast<const __nv_bfloat16*>(x), loga, static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(C), static_cast<__nv_bfloat16*>(y), state, states,
        Tlen, H, P, N, L, g, vec ? 1 : 0);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
