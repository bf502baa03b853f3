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
// bytes bound is ~6.4 us at 3.35 TB/s.
//
// Design (simple and right first):
// * one CTA per tile (grid = B), threads striding over a plane's points;
//   planes are computed in order with __syncthreads() between them, which
//   also makes the previous plane's global writes visible to the CTA;
// * no working copy of the halo: a read of plane p at interior-frame
//   coordinate j comes from the halo buffer when p < 0 or j lies in the
//   low-side halo (j_a < 0 on some axis), else from the plane the CTA
//   already wrote to `out`.  The halo buffer is read, never written;
// * the program is a term table (plane depth, spatial offset, coefficient
//   or additive constant) plus a combine mode — weighted sum, max-plus
//   (smith-waterman) or the gol update — built from programs.py;
// * bit-exact against the plain PyTorch version: every operation is an
//   explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __dmul_rn, ...;
//   the file is also built with -fmad=false), terms combine in table
//   order, and float32 coefficients are the double values rounded to
//   float32, as PyTorch rounds a Python scalar for a float32 tensor.
// Later work: a plane ring in shared memory and several CTAs per tile — one
// CTA per tile leaves half of the 132 SMs idle at 64 tiles per wave.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTerms = 32;
constexpr int kThreads = 512;

enum Combine { kSum = 0, kMaxPlus = 1, kGol = 2 };

struct Terms {
  int n;
  int centre;  // kGol: the term read as the centre value
  int depth[kMaxTerms];   // planes back (1 = previous plane)
  int off[kMaxTerms][3];  // spatial offsets, each <= 0
  double value[kMaxTerms];  // coefficient (kSum) or additive score (kMaxPlus)
};

struct Geometry {
  int w0, t0;  // time halo depth, planes per tile
  int h[3];    // halo-buffer extent per spatial axis
  int w[3];    // low-side halo width per spatial axis
  int t[3];    // interior extent per spatial axis
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

// Plane p (interior frame; p < 0 reads live-in/halo planes) at interior-frame
// spatial coordinate (j0, j1, j2), each >= -w.
template <typename T>
__device__ __forceinline__ T load(const T* __restrict__ halo, const T* done,
                                  const Geometry& g, int p, int j0, int j1,
                                  int j2) {
  if (p < 0 || j0 < 0 || j1 < 0 || j2 < 0) {
    const int64_t plane = g.w0 + p;
    const int64_t x0 = g.w[0] + j0, x1 = g.w[1] + j1, x2 = g.w[2] + j2;
    return halo[((plane * g.h[0] + x0) * g.h[1] + x1) * g.h[2] + x2];
  }
  return done[(((int64_t)p * g.t[0] + j0) * g.t[1] + j1) * g.t[2] + j2];
}

template <typename T, int kCombine>
__global__ void __launch_bounds__(kThreads)
stencil_tiles_kernel(const T* __restrict__ halos, T* out, Geometry g,
                     Terms terms) {
  using A = Arith<T>;
  const int64_t hsize = (int64_t)(g.w0 + g.t0) * g.h[0] * g.h[1] * g.h[2];
  const int64_t plane_pts = (int64_t)g.t[0] * g.t[1] * g.t[2];
  const T* halo = halos + blockIdx.x * hsize;
  T* done = out + blockIdx.x * (g.t0 * plane_pts);

  for (int s = 0; s < g.t0; ++s) {
    for (int64_t i = threadIdx.x; i < plane_pts; i += blockDim.x) {
      const int i2 = (int)(i % g.t[2]);
      const int64_t r = i / g.t[2];
      const int i1 = (int)(r % g.t[1]);
      const int i0 = (int)(r / g.t[1]);
      T acc = T(0);
      T centre = T(0);
      for (int k = 0; k < terms.n; ++k) {
        const T v = load(halo, done, g, s - terms.depth[k], i0 + terms.off[k][0],
                         i1 + terms.off[k][1], i2 + terms.off[k][2]);
        if (kCombine == kSum) {
          const T prod = A::mul(v, static_cast<T>(terms.value[k]));
          acc = (k == 0) ? prod : A::add(acc, prod);
        } else if (kCombine == kMaxPlus) {
          const T cand = A::add(v, static_cast<T>(terms.value[k]));
          acc = (k == 0) ? cand : max_nan(acc, cand);
        } else {  // kGol: neigh = v0 + v1 + ...; 2*centre - neigh/9
          acc = (k == 0) ? v : A::add(acc, v);
          if (k == terms.centre) centre = v;
        }
      }
      if (kCombine == kGol) {
        // a - b as a + (-b): the same rounding, and negation is exact
        acc = A::add(A::mul(T(2), centre), -A::div(acc, T(9)));
      }
      done[s * plane_pts + i] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
void launch(int combine, int batch, const void* halos, void* out,
            const Geometry& g, const Terms& terms, cudaStream_t stream) {
  const T* in = static_cast<const T*>(halos);
  T* o = static_cast<T*>(out);
  if (combine == kSum) {
    stencil_tiles_kernel<T, kSum><<<batch, kThreads, 0, stream>>>(in, o, g, terms);
  } else if (combine == kMaxPlus) {
    stencil_tiles_kernel<T, kMaxPlus><<<batch, kThreads, 0, stream>>>(in, o, g, terms);
  } else {
    stencil_tiles_kernel<T, kGol><<<batch, kThreads, 0, stream>>>(in, o, g, terms);
  }
}

}  // namespace

// C entry point.  Pointers and the stream come in as void*; returns the
// cudaError_t of the launch (0 = launched), or cudaErrorInvalidValue for an
// argument the kernel does not take.
extern "C" int stencil_tiles(int elem_bytes, const void* halos, void* out,
                             int batch, int w0, int t0, const int* halo_ext,
                             const int* halo_w, int combine, int centre,
                             int n_terms, const int* depth, const int* offs,
                             const double* values, void* stream) {
  if (batch < 1 || t0 < 1 || w0 < 1 || n_terms < 1 || n_terms > kMaxTerms ||
      combine < kSum || combine > kGol ||
      (combine == kGol && (centre < 0 || centre >= n_terms))) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g;
  g.w0 = w0;
  g.t0 = t0;
  for (int a = 0; a < 3; ++a) {
    g.h[a] = halo_ext[a];
    g.w[a] = halo_w[a];
    g.t[a] = halo_ext[a] - halo_w[a];
    if (g.t[a] < 1 || g.w[a] < 0) return (int)cudaErrorInvalidValue;
  }
  Terms terms;
  terms.n = n_terms;
  terms.centre = centre;
  for (int k = 0; k < n_terms; ++k) {
    terms.depth[k] = depth[k];
    if (depth[k] < 1 || depth[k] > w0) return (int)cudaErrorInvalidValue;
    for (int a = 0; a < 3; ++a) {
      terms.off[k][a] = offs[3 * k + a];
      if (offs[3 * k + a] > 0 || -offs[3 * k + a] > g.w[a]) {
        return (int)cudaErrorInvalidValue;
      }
    }
    terms.value[k] = values[k];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    launch<float>(combine, batch, halos, out, g, terms, st);
  } else if (elem_bytes == 8) {
    launch<double>(combine, batch, halos, out, g, terms, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
