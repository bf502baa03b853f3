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
// writes over the card's 3.35 TB/s.
//
// Design (simple and right first):
// * bit copies: elements move as 4- or 8-byte words (uint32_t / uint64_t),
//   so the result is bit-exact for float32 and float64 by construction;
// * one pass, one writer per element: one CTA per (interior tile, halo
//   plane x0), threads striding the plane's (x1, x2) points row-major, so
//   the writes of a warp are contiguous;
// * per element the source is chosen by rule instead of by compositing
//   regions.  An axis a is "halo" when x_a < w_a (the point lies in tile
//   q_a - 1's tail slab) and "in-slab" when x_a >= t_a (the point lies in
//   the current tile's own tail slab along a).  Redundant storage reads the
//   facet of the lowest halo axis (the seven `_assemble` pieces).  Points
//   with no halo axis are the tile interior and read as 0.
//   Irredundant storage reads the facet of the lowest halo-or-in-slab axis:
//   the lowest facet whose projection domain holds the point, i.e. its
//   owner.  That is, per element, the last writer of the reference's
//   sequence (seven pieces, then the owner blocks of tiles (q0,q1-1,q2),
//   (q0,q1,q2-1) via facet_1, (q0,q1,q2-1) via facet_0 and
//   (q0,q1-1,q2-1));
// * addressing: within facet k's block at tile q' (q'_a = q_a - halo_a),
//   the modulo coordinate is x_k mod w_k and every other axis's intra-tile
//   coordinate is x_a - w_a (+ t_a when halo).  The element strides of each
//   tile coordinate and each intra-tile coordinate come from the host,
//   computed from the port's FacetSpecs (facet_0's virtual live-in row is a
//   base offset), so the three different outer orders of the layout are not
//   derived a second time here;
// * 64-bit offsets: a full-size output holds ~3e8 elements.
// Later work: one TMA bulk copy per facet block (the paper's burst) into
// shared memory and the transposes from there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int g[3];             // interior tiles per axis
  int w[3];             // facet widths
  int t[3];             // tile sizes
  int h[3];             // halo-buffer extents, w + t
  int irredundant;      // 1: owner-facet indirection
  int64_t base[3];      // facet k: offset of tile row 0 (virtual row on facet_0)
  int64_t outer[3][3];  // facet k: element stride of the tile coordinate on axis a
  int64_t inner[3][3];  // facet k: element stride of the intra-tile coordinate on axis a
};

template <typename W>
__global__ void __launch_bounds__(kThreads)
facet_fetch_kernel(const W* __restrict__ f0, const W* __restrict__ f1,
                   const W* __restrict__ f2, W* __restrict__ out, Geometry g) {
  const int64_t blk = blockIdx.x;  // (tile, x0) row-major
  const int x0 = (int)(blk % g.h[0]);
  const int64_t tile = blk / g.h[0];
  const int q[3] = {(int)(tile / ((int64_t)g.g[1] * g.g[2])) + 1,
                    (int)((tile / g.g[2]) % g.g[1]) + 1,
                    (int)(tile % g.g[2]) + 1};
  const int plane = g.h[1] * g.h[2];
  W* dst = out + blk * plane;
  const W* facet[3] = {f0, f1, f2};

  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    const int x1 = i / g.h[2];
    const int x[3] = {x0, x1, i - x1 * g.h[2]};
    bool halo[3];
    bool any_halo = false;
    int owner = -1;
    for (int a = 0; a < 3; ++a) {
      halo[a] = x[a] < g.w[a];
      any_halo |= halo[a];
      if (owner < 0 && (halo[a] || (g.irredundant && x[a] >= g.t[a]))) owner = a;
    }
    W v = 0;  // the tile interior
    if (any_halo) {
      int64_t off = g.base[owner];
      for (int a = 0; a < 3; ++a) {
        const int idx = (a == owner) ? x[a] % g.w[a]
                                     : x[a] - g.w[a] + (halo[a] ? g.t[a] : 0);
        off += (int64_t)(q[a] - halo[a]) * g.outer[owner][a] +
               (int64_t)idx * g.inner[owner][a];
      }
      v = facet[owner][off];
    }
    dst[i] = v;
  }
}

}  // namespace

// C entry point.  Pointers and the stream come in as void*; `ints` holds
// g[3], w[3], t[3], irredundant; `strides` holds base[3], outer[3][3] and
// inner[3][3] (row-major, facet first).  Returns the cudaError_t of the
// launch (0 = launched), or cudaErrorInvalidValue for an argument the
// kernel does not take.
extern "C" int facet_fetch(int elem_bytes, const void* f0, const void* f1,
                           const void* f2, void* out, const int* ints,
                           const int64_t* strides, void* stream) {
  Geometry g;
  for (int a = 0; a < 3; ++a) {
    g.g[a] = ints[a];
    g.w[a] = ints[3 + a];
    g.t[a] = ints[6 + a];
    g.h[a] = g.w[a] + g.t[a];
    if (g.g[a] < 1 || g.w[a] < 1 || g.t[a] < g.w[a] || g.t[a] % g.w[a]) {
      return (int)cudaErrorInvalidValue;
    }
  }
  g.irredundant = ints[9] != 0;
  for (int k = 0; k < 3; ++k) {
    g.base[k] = strides[k];
    for (int a = 0; a < 3; ++a) {
      g.outer[k][a] = strides[3 + 3 * k + a];
      g.inner[k][a] = strides[12 + 3 * k + a];
    }
  }
  const int64_t blocks = (int64_t)g.g[0] * g.g[1] * g.g[2] * g.h[0];
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    facet_fetch_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(f0), static_cast<const uint32_t*>(f1),
        static_cast<const uint32_t*>(f2), static_cast<uint32_t*>(out), g);
  } else if (elem_bytes == 8) {
    facet_fetch_kernel<uint64_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint64_t*>(f0), static_cast<const uint64_t*>(f1),
        static_cast<const uint64_t*>(f2), static_cast<uint64_t*>(out), g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
