// CFA stencil tile executor for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces: src/repro/kernels/stencil/stencil.py::execute_tiles (the Pallas
// kernel `_tile_kernel`).  Given B halo buffers of shape
// (w0+t0, h1, h2, h3) — a tile's flow-in gathered from facet storage, with a
// low-side halo of width w_a on every axis — it runs the program's plane
// recurrence for t0 planes and writes the (B, t0, t1, t2, t3) interiors.
// Spatial ranks 1..3 (heat1d, the 3-D Table I suite, heat3d) are padded to
// three spatial axes with unit extents by the wrapper.
//
// What bounds it: memory.  Each interior point costs one output write and
// a handful of reads, and a jacobi2d5p point needs 9 flops per 8 bytes of
// halo-in plus interior-out traffic, far below the card's ~20 flop/byte
// ridge in float32.  At the main path's shape (64 tiles of (3,130,130)) the
// bytes bound is ~6.4 us at 3.35 TB/s.  What held the first version (one
// CTA per tile, every term a global load) back was latency and occupancy:
// 64 of 132 SMs busy per wave, one SM per single-tile launch, and each
// plane re-read from global memory.
//
// Design:
// * a thread-block cluster of k CTAs per tile (k <= 8, launched with
//   cudaLaunchKernelEx and a cluster dimension; a plain launch at k = 1);
//   each CTA owns a strip of `strip` rows of the tile along one spatial
//   axis (the split axis), so a wave of B tiles fills B*k CTAs and a single
//   tile k SMs;
// * every CTA keeps a ring of w0+1+ahead planes of its strip in shared
//   memory, each plane with its full low-side halo (the w_s rows below the
//   strip on the split axis included).  A term reads only shared memory;
//   global memory sees each halo element read once and each interior
//   element written once;
// * all offsets are <= 0, so a strip needs only the w_s rows just below it
//   from its lower neighbour: a CTA writes its last w_s computed rows of a
//   plane straight into its upper neighbour's ring slot through distributed
//   shared memory, and one cluster barrier per plane (release/acquire)
//   publishes both the local and the remote writes (a CTA barrier at k = 1);
// * the live-in planes (p < 0) and every plane's own low-side halo come
//   from the halo buffer by cp.async, `ahead` planes before they are needed
//   (one commit group per plane), so their latency hides behind the planes
//   being computed; where a slot per plane fits (ahead = t0 - 1), all of
//   them come in before the first plane and the plane loop waits on none.
//   A plane's halo parts are the same slot elements every plane: their
//   (slot, halo) offsets are listed once per CTA in shared memory.  The
//   copies are element-wise, coalesced along the innermost axis: a halo row
//   of w_2 + t_2 elements is not a 16-byte multiple at the paths' shapes
//   (130 floats), which rules out 16-byte copies and TMA.  The halo buffer
//   is read, never written;
// * 32-bit index math: the per-point coordinates advance by carries, never
//   by a div/mod; each thread takes two points per step, their term loads
//   issued together;
// * the program is a term table (plane depth, spatial offset, coefficient
//   or additive constant) plus a combine mode — weighted sum, max-plus
//   (smith-waterman) or the gol update — built from programs.py, its terms
//   unrolled into registers (one kernel per combine mode and term count of
//   the programs' tables);
// * bit-exact against the plain PyTorch version: every operation is an
//   explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __dmul_rn, ...;
//   the file is also built with -fmad=false), terms combine in table
//   order, and float32 coefficients are the double values rounded to
//   float32, as PyTorch rounds a Python scalar for a float32 tensor.  Only
//   where a value is read from changes, never how it is combined.
// The wrapper's launch_plan (stencil.py) picks the split axis, k and
// `ahead`; this file recomputes the strip and the shared memory and
// rejects a plan it cannot run.
// What still holds it back: at k > 1 a cluster barrier per plane, dearer
// than a CTA barrier (its release covers the plane's global stores as well
// as the ring); and each plane is a chain of dependent shared-memory reads,
// arithmetic and a barrier, which a small plane cannot hide.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxTerms = 32;
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kMaxAhead = 7;
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

enum Combine { kSum = 0, kMaxPlus = 1, kGol = 2 };

struct Terms {
  int n;
  int centre;  // kGol: the term read as the centre value
  int depth[kMaxTerms];   // planes back (1 = previous plane)
  int off[kMaxTerms][3];  // spatial offsets, each <= 0
  double value[kMaxTerms];  // coefficient (kSum) or additive score (kMaxPlus)
};

struct Geometry {
  int w0, t0;   // time halo depth, planes per tile
  int h[3];     // halo-buffer extent per spatial axis
  int w[3];     // low-side halo width per spatial axis
  int t[3];     // interior extent per spatial axis
  int split;    // the axis the tile is cut along
  int k;        // CTAs per tile (the cluster)
  int strip;    // interior rows per CTA on the split axis (the last may hold fewer)
  int ahead;    // planes whose halo parts are loaded before they are needed
                // (>= t0 - 1: all of them, before the first plane)
  int ring;     // plane slots per CTA: w0 + 1 + ahead
  int e[3];     // slot extents: h, with w[split] + strip on the split axis
  int ring_bytes;  // the ring's shared memory; the halo-part offset list follows
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <> struct Arith<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
};

// torch.maximum: NaN-propagating, first operand on ties
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return (a < b) ? b : a;
}

__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most n of this thread's commit groups are pending
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Copy the box lo <= u < hi (slot coordinates) of halo-buffer plane `hplane`
// into ring slot `slot`; slot coordinate u is halo-frame coordinate u, plus
// r0 on the split axis.  Neighbouring threads take neighbouring elements.
template <typename T>
__device__ void load_box(T* slot, const T* __restrict__ hplane, const Geometry& g, int r0,
                         int lo0, int lo1, int lo2, int hi0, int hi1, int hi2) {
  const int n0 = hi0 - lo0, n1 = hi1 - lo1, n2 = hi2 - lo2;
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return;
  const int count = n0 * n1 * n2;
  const int d0 = g.split == 0 ? r0 : 0, d1 = g.split == 1 ? r0 : 0, d2 = g.split == 2 ? r0 : 0;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int v2 = i % n2, r = i / n2;
    const int u2 = lo2 + v2, u1 = lo1 + r % n1, u0 = lo0 + r / n1;
    copy_async(slot + (u0 * g.e[1] + u1) * g.e[2] + u2,
               hplane + ((u0 + d0) * g.h[1] + u1 + d1) * g.h[2] + u2 + d2, (int)sizeof(T));
  }
}

// The parts of plane p's slot that come from the halo buffer: every element
// in the tile's low-side halo of an axis other than the split axis (and, in
// the cluster's first CTA, of the split axis too), as disjoint boxes.  The
// rows below a later CTA's strip arrive from its neighbour instead.  They are
// the same elements in every plane, so their (slot, halo-plane) offsets are
// listed once, here, and each plane's copy walks the list.
__device__ __host__ inline int halo_part_boxes(const Geometry& g, int len, bool first,
                                               int box[3][6]) {
  int nb = 0;
  int lo[3] = {0, 0, 0};
  int hi[3] = {g.e[0], g.e[1], g.e[2]};
  hi[g.split] = g.w[g.split] + len;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (g.w[a] > 0 && (g.split != a || first)) {
      for (int c = 0; c < 3; ++c) {
        box[nb][c] = lo[c];
        box[nb][3 + c] = c == a ? g.w[a] : hi[c];
      }
      ++nb;
      lo[a] = g.w[a];  // later boxes exclude this axis's halo: the boxes are disjoint
    }
  }
  return nb;
}

__device__ __host__ inline int box_count(const int b[6]) {
  const int n0 = b[3] - b[0], n1 = b[4] - b[1], n2 = b[5] - b[2];
  return n0 > 0 && n1 > 0 && n2 > 0 ? n0 * n1 * n2 : 0;
}

// halo-part elements of one CTA: the first CTA's count bounds every CTA's
__host__ inline int halo_part_count(const Geometry& g) {
  int box[3][6];
  const int nb = halo_part_boxes(g, g.strip, true, box);
  int n = 0;
  for (int i = 0; i < nb; ++i) n += box_count(box[i]);
  return n;
}

// Fill `list` with (slot offset, halo-plane offset) pairs; returns the count.
__device__ int build_halo_list(int2* list, const Geometry& g, int r0, int len, bool first) {
  int box[3][6];
  const int nb = halo_part_boxes(g, len, first, box);
  const int d0 = g.split == 0 ? r0 : 0, d1 = g.split == 1 ? r0 : 0, d2 = g.split == 2 ? r0 : 0;
  int base = 0;
  for (int j = 0; j < nb; ++j) {
    const int n1 = box[j][4] - box[j][1], n2 = box[j][5] - box[j][2];
    const int count = box_count(box[j]);
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const int v2 = i % n2, r = i / n2;
      const int u2 = box[j][2] + v2, u1 = box[j][1] + r % n1, u0 = box[j][0] + r / n1;
      list[base + i] = make_int2((u0 * g.e[1] + u1) * g.e[2] + u2,
                                 ((u0 + d0) * g.h[1] + u1 + d1) * g.h[2] + u2 + d2);
    }
    base += count;
  }
  return base;
}

template <typename T>
__device__ __forceinline__ void load_halo_parts(T* slot, const T* __restrict__ hplane,
                                                const int2* list, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int2 o = list[i];
    copy_async(slot + o.x, hplane + o.y, (int)sizeof(T));
  }
}

// One point: every term read from the ring (offsets relative to the point's
// slot index `base`), then combined in table order; kN is the table's
// length, its offsets and values are in registers.
template <typename T, int kCombine>
__device__ __forceinline__ T combine_term(T acc, T v, T c, int k) {
  using A = Arith<T>;
  if (kCombine == kSum) {
    const T prod = A::mul(v, c);
    return (k == 0) ? prod : A::add(acc, prod);
  } else if (kCombine == kMaxPlus) {
    const T cand = A::add(v, c);
    return (k == 0) ? cand : max_nan(acc, cand);
  }
  return (k == 0) ? v : A::add(acc, v);  // kGol: neigh = v0 + v1 + ...
}

template <typename T, int kCombine>
__device__ __forceinline__ T finish(T acc, T centre) {
  using A = Arith<T>;
  // kGol: 2*centre - neigh/9, a - b as a + (-b): the same rounding, and
  // negation is exact
  if (kCombine == kGol) return A::add(A::mul(T(2), centre), -A::div(acc, T(9)));
  return acc;
}

template <typename T, int kCombine, int kN>
__device__ __forceinline__ T eval_point(const T* ring, int base, const int (&toff)[kN],
                                        const T (&val)[kN], int centre) {
  T v[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) v[k] = ring[base + toff[k]];
  T acc = T(0), c = T(0);
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    acc = combine_term<T, kCombine>(acc, v[k], val[k], k);
    if (kCombine == kGol && k == centre) c = v[k];
  }
  return finish<T, kCombine>(acc, c);
}

// (i0, i1, i2) += a stride given as carries over the extents (n1, n2)
struct Coord {
  int i0, i1, i2;
  __device__ __forceinline__ void advance(int s0, int s1, int s2, int n1, int n2) {
    i2 += s2;
    if (i2 >= n2) { i2 -= n2; ++i1; }
    i1 += s1;
    if (i1 >= n1) { i1 -= n1; ++i0; }
    i0 += s0;
  }
};

template <typename T, int kCombine, int kN>
__global__ void __launch_bounds__(kThreads)
stencil_tiles_kernel(const T* __restrict__ halos, T* __restrict__ out, Geometry g,
                     Terms terms) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  int2* hlist = reinterpret_cast<int2*>(smem_raw + g.ring_bytes);  // halo-part offsets

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / g.k;
  const int s = g.split;
  const int ts = s == 0 ? g.t[0] : (s == 1 ? g.t[1] : g.t[2]);
  const int ws = s == 0 ? g.w[0] : (s == 1 ? g.w[1] : g.w[2]);
  const int r0 = rank * g.strip;
  const int len = min(g.strip, ts - r0);
  const int S1 = g.e[2], S0 = g.e[1] * g.e[2];
  const int sstride = s == 0 ? S0 : (s == 1 ? S1 : 1);
  const int slot_elems = g.e[0] * S0;
  const int hplane_elems = g.h[0] * g.h[1] * g.h[2];
  const int plane_pts = g.t[0] * g.t[1] * g.t[2];
  const T* halo = halos + (size_t)tile * (size_t)((g.w0 + g.t0) * hplane_elems);
  T* dst = out + (size_t)tile * (size_t)(g.t0 * plane_pts);
  T* next = rank + 1 < g.k ? cluster.map_shared_rank(ring, rank + 1) : nullptr;

  // interior extent of this CTA's strip, per axis
  const int n0 = s == 0 ? len : g.t[0], n1 = s == 1 ? len : g.t[1],
            n2 = s == 2 ? len : g.t[2];
  const int npts = n0 * n1 * n2;
  // two points per step, kThreads apart: the first points and the step, as carries
  constexpr int step = 2 * kThreads;
  const int st2 = step % n2, st1 = (step / n2) % n1, st0 = step / (n2 * n1);
  const int f2 = threadIdx.x % n2, f1 = (threadIdx.x / n2) % n1, f0 = threadIdx.x / (n2 * n1);
  const int j = threadIdx.x + kThreads;
  const int h2 = j % n2, h1 = (j / n2) % n1, h0 = j / (n2 * n1);
  // a point's offsets: slot index, output index, split-axis coordinate
  const int ro0 = s == 0 ? r0 : 0, ro1 = s == 1 ? r0 : 0, ro2 = s == 2 ? r0 : 0;

  // each term's offset within a slot, plane depth and coefficient
  int roff[kN], rdep[kN];
  T rval[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    roff[k] = terms.off[k][0] * S0 + terms.off[k][1] * S1 + terms.off[k][2];
    rdep[k] = terms.depth[k];
    rval[k] = static_cast<T>(terms.value[k]);
  }
  const int nlist = build_halo_list(hlist, g, r0, len, rank == 0);

  // live-in planes p = -w0 .. -1, whole (halo frame), one commit group
  {
    const int hi0 = s == 0 ? g.w[0] + len : g.e[0];
    const int hi1 = s == 1 ? g.w[1] + len : g.e[1];
    const int hi2 = s == 2 ? g.w[2] + len : g.e[2];
    for (int p = -g.w0; p < 0; ++p) {
      load_box(ring + (g.ring + p) * slot_elems, halo + (g.w0 + p) * hplane_elems, g, r0, 0, 0,
               0, hi0, hi1, hi2);
    }
    commit_group();
  }
  __syncthreads();  // the offset list
  // preload: every plane has a slot of its own, and all halo parts come in
  // before the first plane (one group); else the halo parts of planes
  // 0 .. ahead-1, a group each
  const bool preload = g.ahead >= g.t0 - 1;
  if (preload) {
    for (int p = 0; p < g.t0; ++p) {
      load_halo_parts(ring + p * slot_elems, halo + (g.w0 + p) * hplane_elems, hlist, nlist);
    }
    commit_group();
    wait_groups(0);
  } else {
    for (int p = 0; p < g.ahead; ++p) {
      load_halo_parts(ring + p * slot_elems, halo + (g.w0 + p) * hplane_elems, hlist, nlist);
      commit_group();
    }
    wait_groups(g.ahead);  // the live-in planes are in
  }
  cluster.sync();  // ... for every thread, and every CTA of the cluster runs

  int qcur = 0;                          // plane p's slot: p mod ring
  int qahead = g.ahead % g.ring;         // plane p+ahead's slot
  for (int p = 0; p < g.t0; ++p) {
    if (!preload) {
      if (p + g.ahead < g.t0) {
        load_halo_parts(ring + qahead * slot_elems, halo + (g.w0 + p + g.ahead) * hplane_elems,
                        hlist, nlist);
      }
      commit_group();
    }

    int toff[kN];  // each term's offset from a point's slot index, this plane
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int q = qcur - rdep[k];
      toff[k] = (q < 0 ? q + g.ring : q) * slot_elems + roff[k];
    }
    const int cur = qcur * slot_elems;
    // the upper neighbour's slot of plane p, shifted so that a point's own
    // slot index lands on its row below that neighbour's strip
    const int remote_base = cur - len * sstride;
    T* dplane = dst + p * plane_pts;
    Coord a{f0, f1, f2}, b{h0, h1, h2};
    for (int i = threadIdx.x; i < npts; i += step) {
      const bool two = i + kThreads < npts;
      const int base_a = ((a.i0 + g.w[0]) * g.e[1] + a.i1 + g.w[1]) * g.e[2] + a.i2 + g.w[2];
      const int base_b = ((b.i0 + g.w[0]) * g.e[1] + b.i1 + g.w[1]) * g.e[2] + b.i2 + g.w[2];
      const T va = eval_point<T, kCombine, kN>(ring, base_a, toff, rval, terms.centre);
      const T vb = two ? eval_point<T, kCombine, kN>(ring, base_b, toff, rval, terms.centre)
                       : T(0);
      ring[cur + base_a] = va;
      dplane[((a.i0 + ro0) * g.t[1] + a.i1 + ro1) * g.t[2] + a.i2 + ro2] = va;
      // the strip's last w_s rows are the upper neighbour's low-side halo
      if (next != nullptr && (s == 0 ? a.i0 : (s == 1 ? a.i1 : a.i2)) >= len - ws) {
        next[remote_base + base_a] = va;
      }
      if (two) {
        ring[cur + base_b] = vb;
        dplane[((b.i0 + ro0) * g.t[1] + b.i1 + ro1) * g.t[2] + b.i2 + ro2] = vb;
        if (next != nullptr && (s == 0 ? b.i0 : (s == 1 ? b.i1 : b.i2)) >= len - ws) {
          next[remote_base + base_b] = vb;
        }
      }
      a.advance(st0, st1, st2, n1, n2);
      b.advance(st0, st1, st2, n1, n2);
    }
    qcur = qcur + 1 == g.ring ? 0 : qcur + 1;
    qahead = qahead + 1 == g.ring ? 0 : qahead + 1;
    if (!preload) wait_groups(g.ahead);  // plane p's halo parts are in
    // plane p complete in every CTA's ring, the rows written to the next CTA
    // included (a CTA barrier where the cluster is one CTA)
    if (g.k > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  }
}

template <typename T, int kCombine, int kN>
cudaError_t launch_one(int batch, const T* in, T* o, const Geometry& g, const Terms& terms,
                       size_t smem, cudaStream_t stream) {
  auto kernel = stencil_tiles_kernel<T, kCombine, kN>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * g.k), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.k > 1 ? 1 : 0;  // one CTA per tile: a plain launch
  return cudaLaunchKernelEx(&cfg, kernel, in, o, g, terms);
}

template <typename T>
cudaError_t launch(int combine, int batch, const void* halos, void* out, const Geometry& g,
                   const Terms& terms, size_t smem, cudaStream_t stream) {
  const T* in = static_cast<const T*>(halos);
  T* o = static_cast<T*>(out);
  // one kernel per (combine, term count) of the programs' tables
  // (programs.term_table; stencil.py's KERNEL_TABLES), the terms unrolled
  if (combine == kSum) {
    switch (terms.n) {
      case 3: return launch_one<T, kSum, 3>(batch, in, o, g, terms, smem, stream);
      case 5: return launch_one<T, kSum, 5>(batch, in, o, g, terms, smem, stream);
      case 7: return launch_one<T, kSum, 7>(batch, in, o, g, terms, smem, stream);
      case 9: return launch_one<T, kSum, 9>(batch, in, o, g, terms, smem, stream);
      case 25: return launch_one<T, kSum, 25>(batch, in, o, g, terms, smem, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (combine == kMaxPlus && terms.n == 7) {
    return launch_one<T, kMaxPlus, 7>(batch, in, o, g, terms, smem, stream);
  }
  if (combine == kGol && terms.n == 9) {
    return launch_one<T, kGol, 9>(batch, in, o, g, terms, smem, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point.  Pointers and the stream come in as void*; `split`, `k` and
// `ahead` are the wrapper's launch plan.  Returns the cudaError_t of the
// launch (0 = launched; a cluster or shared-memory request the card refuses
// comes back here), or cudaErrorInvalidValue for an argument the kernel does
// not take.
extern "C" int stencil_tiles(int elem_bytes, const void* halos, void* out,
                             int batch, int w0, int t0, const int* halo_ext,
                             const int* halo_w, int combine, int centre,
                             int n_terms, const int* depth, const int* offs,
                             const double* values, int split, int k, int ahead,
                             void* stream) {
  if (batch < 1 || t0 < 1 || w0 < 1 || n_terms < 1 || n_terms > kMaxTerms ||
      combine < kSum || combine > kGol || (elem_bytes != 4 && elem_bytes != 8) ||
      (combine == kGol && (centre < 0 || centre >= n_terms)) || split < 0 || split > 2 ||
      k < 1 || k > kMaxCluster || ahead < 0 || (ahead > kMaxAhead && ahead < t0 - 1) ||
      (int64_t)batch * k > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g;
  g.w0 = w0;
  g.t0 = t0;
  int64_t hplane = 1;
  for (int a = 0; a < 3; ++a) {
    g.h[a] = halo_ext[a];
    g.w[a] = halo_w[a];
    g.t[a] = halo_ext[a] - halo_w[a];
    if (g.t[a] < 1 || g.w[a] < 0) return (int)cudaErrorInvalidValue;
    hplane *= g.h[a];
  }
  // 32-bit index math within a tile
  if (hplane * (w0 + t0) > 0x7fffffff) return (int)cudaErrorInvalidValue;
  g.split = split;
  g.k = k;
  g.ahead = ahead;
  g.ring = w0 + 1 + ahead;
  g.strip = (g.t[split] + k - 1) / k;
  // every CTA holds rows, and every strip but the last covers its
  // neighbour's low-side halo
  if ((k - 1) * g.strip >= g.t[split] || (k > 1 && g.strip < g.w[split])) {
    return (int)cudaErrorInvalidValue;
  }
  for (int a = 0; a < 3; ++a) g.e[a] = g.h[a];
  g.e[split] = g.w[split] + g.strip;
  const size_t ring_bytes = (size_t)g.ring * g.e[0] * g.e[1] * g.e[2] * elem_bytes;
  if (ring_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  g.ring_bytes = (int)((ring_bytes + 15) / 16 * 16);
  const size_t smem = g.ring_bytes + sizeof(int2) * (size_t)halo_part_count(g);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Terms terms;
  terms.n = n_terms;
  terms.centre = centre;
  for (int i = 0; i < n_terms; ++i) {
    terms.depth[i] = depth[i];
    if (depth[i] < 1 || depth[i] > w0) return (int)cudaErrorInvalidValue;
    for (int a = 0; a < 3; ++a) {
      terms.off[i][a] = offs[3 * i + a];
      if (offs[3 * i + a] > 0 || -offs[3 * i + a] > g.w[a]) {
        return (int)cudaErrorInvalidValue;
      }
    }
    terms.value[i] = values[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = elem_bytes == 4 ? launch<float>(combine, batch, halos, out, g, terms, smem, st)
                                    : launch<double>(combine, batch, halos, out, g, terms, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
