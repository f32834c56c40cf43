// K7: the carry-top body for Hopper (sm_90a), one thread per ray with its
// own stack: the counterpart of the Pallas body _kernel_ct of
// rodent_tpu/traversal/pallas_packet.py (:878-1131), which the JAX package
// runs with traverse_packet(carry_top=True, select=..., fma_slab=...) on
// its headline traversal row.
//
// _kernel_ct walks a tile of rays with one shared stack; for one ray its
// tile is octant-pure, so the rules it keeps per ray are these (the plain
// torch version, traversal/api.py traverse_ct_components, follows them in
// the same float operation order; built with -fmad=false, the two agree
// bit for bit):
//
//   the next pop in a register: the code of the next pop is carried, not
//       stored (the reference's top-of-stack trick, stack.impala:25-50):
//       a node's chosen child, a leaf's next Tri row (code - 1 while lane
//       M-1's pid sign bit is clear), else the stack's top, read at the
//       pop's start from the stack as it stood before the pop's pushes
//       (the peek: a local load issued early, off the chain of dependent
//       row loads) and then popped.
//   the ordered slab: per ray, once, the row offsets of each axis' near
//       and far plane, picked by the sign of the raw inverse (the
//       reference's ordered_bbox, intersection.impala:194-202): three
//       planes into the entry, three into the exit, with no min/max of
//       the pairs. FMA (fma_slab): each plane is __fmaf_rn(b, inv, io)
//       with inv clamped to +-2^62 and io = -(org * inv), rounded once
//       (intersection.impala:194-196); else (b - org) * inv. A child
//       counts where its entry is at most its exit.
//   child selection: closest-hit takes the nearest child by a strict-<
//       min-fold over the slots (the first of equal keys; SORT = false) or
//       by the Batcher network (SORT = true, sort_children); any-hit takes
//       the lowest slot. The other children that count are pushed from
//       slot A-1 down to 0, so the lowest ends on top (under SORT, the
//       nearest).
//   the leaf is K1's (csrc/bvh_traverse.cu): sign-trick Moller-Trumbore
//       over the M lanes, lanes tested against t as the pop began and
//       updated on the strict t < t_cur, the first hit found kept; any-hit
//       ends the ray at the leaf that hits.
//   COUNT: K3's counters, every pop and its leaf pops.
//   PF (K7-PF): the exact next-pop L2 prefetch of _pf_helpers
//       (pallas_packet.py:96-219), as _kernel_ct drives it with the carried
//       code (:905-931, :1054-1055, :1076-1080): at each pop the next pop
//       is known exactly (_next_top, :222-228), `next` when it is not 0,
//       else the peek; where that pop is a leaf, its whole Tri row is
//       brought into L2 with K2's prefetch_entry (bvh_common.cuh), one
//       prefetch.global.L2 per 128-byte line (6 for a 672 B Tri12 row, 11
//       for a 1,344 B Tri24 row, and one for a row's last byte). A node
//       pop issues it after the child selection and before the pushes; a
//       leaf pop as soon as lane M-1's pid gives the continuation, before
//       the M-lane loop, so the row's fetch flies during the intersection
//       arithmetic. Any-hit issues it at the same points; a prefetch still
//       in flight at the ray's break is harmless (the TPU's pf_drain waits
//       on a DMA; nothing here waits). It moves bytes into L2 and no bit
//       of the result, so K7-PF returns K7's hits. Tri rows only, as K2:
//       on the card every table sits behind the 50 MB L2, powerplant-4.3M's
//       6.3 MB node table stays L2-resident, and prefetching node rows as
//       well ran up to 3% slower than Tri rows alone for K2
//       (bvh_traverse.cu, PERF.md), so the JAX nodes_hbm (the giga tier)
//       takes the same kernel. The JAX wrapper never prefetches with
//       counters (:1537-1538): PF excludes COUNT. Measured against K7 in
//       turns on powerplant-4.3M's sorted primaries, bounce and ao rays
//       (PERF.md), K7-PF ran 1-6% slower, with fewer registers (56 against
//       64 for the fused closest-hit body): at 32 or more resident warps
//       an SM the row loads' latency is already hidden, and the
//       prefetches are issued work, most of it on the leaf pops.
//
// The loop is a while-while loop, as the reference's GPU traversal
// (mapping_gpu.impala:94-178) and the Aila-Laine kernel it is measured
// against are: an outer loop over two inner ones, node pops while a ray's
// next pop is a node, then leaf pops while it is a Tri row. A warp runs a
// path whenever any of its rays takes it. In the if-if form (`if (code >
// 0) node; else leaf;` once a trip) a warp whose rays are split between
// node and leaf pops runs both paths in that trip; here a ray that holds
// a leaf waits in the node loop until every ray of the warp holds one or
// is done, and the leaves run together (experiments/ct_warp_model.py
// counts each form's path runs per warp from the rays' pop kinds). Each
// ray still pops the same entries in the same order, with the same t,
// stack and carried next pop, so hits and counters are unchanged.
// Rows are read in 16-byte read-only loads, as the reference's nvvm_ldg4
// (mapping_gpu.impala:18-70) and K4's row_loads: a BVH8 node row (224 B)
// as 14, each plane's 8 children and the child codes as two; a Tri row's
// fields kLeafLanes lanes at a time (a row is 56M bytes, a field 4M),
// the lanes still tested in order 0..M-1. The wrapper refuses tables that
// are not 16-byte aligned (traversal/packet.py).
//
// With SORT and without FMA the kernel pops what K1 pops, in K1's order
// (K1 pushes the nearest child and pops it at once; a leaf's continuation
// likewise), so it returns K1's hits bit for bit and K3's counts.
//
// The stack holds the pushed siblings only: never more entries than K1's
// stack holds in the same order (one fewer a node pop, no continuation),
// so the wrapper gives it K1's compile-time cap (traversal/packet.py
// stack_cap: the tree's worst case BvhMeta.shared_stack + 2, 64 or 128).
//
// What it is meant to cut against K1 (a node pop is 490 warp instructions
// there, experiments/sass_audit.py): the min/max of the slab pairs (six a
// child), a subtract or a multiply a plane under FMA, the Batcher
// network's 19 exchanges under the fold (7 compare-selects), and a local
// store and load a pop. A fold pushes the other children in slot order,
// not by distance, which can add pops; chip_smoke.py and
// experiments/measure_ct.py time both against K1.
//
// Instantiated for BVH8 x Tri8/12/16/24 x stack 64/128 x {closest-hit
// fold, closest-hit sort, any-hit} x {FMA, not} x {counters, not}, and the
// same with PF and without counters: 96 + 48 = 144 kernels, the "ct"
// library (kernels/build.py).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "bvh_common.cuh"  // Ray, sort_children, mt_lane, prefetch_entry

namespace {

constexpr int kBlock = 128;
// the fused slab's inverse clamp, 2^62 (pallas_packet.py _INV_CAP)
constexpr float kInvCap = 4611686018427387904.0f;

struct Args {
  const float* nodes;  // (N, 7A)
  const float* tris;   // (P, 14M)
  // ray components, each (n,): inv_dir xyz, org xyz, dir xyz, tmin, tmax
  const float* ix; const float* iy; const float* iz;
  const float* ox; const float* oy; const float* oz;
  const float* dx; const float* dy; const float* dz;
  const float* tmin; const float* tmax;
  long long n;
  float* t;
  float* u;
  float* v;
  int* prim;
  int* geom;
  int* pops;       // COUNT: (n,) pops per ray
  int* leaf_pops;  // COUNT: (n,) leaf pops per ray
};

// One slab plane's distance: the fused form b * s + o (s the clamped
// inverse, o = -(org * s)), else (b - o) * s (o the origin, s the inverse).
template <bool FMA>
__device__ __forceinline__ float plane(float b, float s, float o) {
  if constexpr (FMA) return __fmaf_rn(b, s, o);
  else return (b - o) * s;
}

// A leaf reads its Tri row kLeafLanes lanes at a time, one float4 load a
// field (the row is laid out by field: lanes of a field are neighbours).
// The 13 loads of a quad hold 52 registers, 92-96 in all (20 warps an SM);
// 8-byte pairs held 62-70 and ran slower on hall's primaries (PERF.md).
constexpr int kLeafLanes = 4;

template <bool ANY_HIT, int A, int M, int STACK, bool SORT, bool FMA,
          bool COUNT, bool PF>
__global__ void __launch_bounds__(kBlock) bvh_ct_kernel(Args a) {
  static_assert(!(PF && COUNT), "the prefetch runs without counters");
  static_assert(A % 4 == 0 && M % kLeafLanes == 0,
                "rows are read in 16-byte loads");
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const Ray r{a.ix[i], a.iy[i], a.iz[i], a.ox[i], a.oy[i], a.oz[i],
              a.dx[i], a.dy[i], a.dz[i], a.tmin[i]};
  const float tmax = a.tmax[i];

  // per ray: the near and far plane of each axis as float4 offsets into a
  // node row (xmin, xmax, ymin, ymax, zmin, zmax, child codes: A floats
  // each, Q = A / 4 float4s), the scale and the offset of each plane's
  // distance
  constexpr int Q = A / 4;
  const int nx = r.ix >= 0.0f ? 0 : Q;
  const int ny = r.iy >= 0.0f ? 2 * Q : 3 * Q;
  const int nz = r.iz >= 0.0f ? 4 * Q : 5 * Q;
  const int fx = Q - nx, fy = 5 * Q - ny, fz = 9 * Q - nz;
  float sx = r.ix, sy = r.iy, sz = r.iz;
  float bx = r.ox, by = r.oy, bz = r.oz;
  if constexpr (FMA) {
    sx = fminf(fmaxf(sx, -kInvCap), kInvCap);
    sy = fminf(fmaxf(sy, -kInvCap), kInvCap);
    sz = fminf(fmaxf(sz, -kInvCap), kInvCap);
    bx = -(r.ox * sx);
    by = -(r.oy * sy);
    bz = -(r.oz * sz);
  }

  float t = tmax, u = 0.0f, v = 0.0f;
  int prim = -1, geom = -1;
  int stack[STACK];
  stack[0] = 0;
  int sp = 0;
  int pops = 0, leaf_pops = 0;
  int code = tmax >= r.tmin ? 1 : 0;  // root ref; dead rays never start
  const float4* nodes4 = reinterpret_cast<const float4*>(a.nodes);

  while (code != 0) {
    // node pops while the next pop is a node: a warp leaves this loop once
    // every ray in it holds a leaf or is done, and runs the leaves together
    while (code > 0) {
      if constexpr (COUNT) ++pops;
      // the peek: the next pop when this one chooses none
      const int below = stack[sp > 0 ? sp - 1 : 0];
      const int peek = sp > 0 ? below : 0;
      const float4* row = nodes4 + (long long)(code - 1) * (7 * Q);
      float key[A];
      int ch[A];
#pragma unroll
      for (int h = 0; h < Q; ++h) {
        const float4 xn = __ldg(row + nx + h), xf = __ldg(row + fx + h);
        const float4 yn = __ldg(row + ny + h), yf = __ldg(row + fy + h);
        const float4 zn = __ldg(row + nz + h), zf = __ldg(row + fz + h);
        const float4 cc = __ldg(row + 6 * Q + h);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * h + j;
          const float entry =
              fmaxf(fmaxf(plane<FMA>(lane_of(xn, j), sx, bx),
                          plane<FMA>(lane_of(yn, j), sy, by)),
                    fmaxf(plane<FMA>(lane_of(zn, j), sz, bz), r.tmin));
          const float exit =
              fminf(fminf(plane<FMA>(lane_of(xf, j), sx, bx),
                          plane<FMA>(lane_of(yf, j), sy, by)),
                    fminf(plane<FMA>(lane_of(zf, j), sz, bz), t));
          const int child = __float_as_int(lane_of(cc, j));
          const float k = entry <= exit ? entry : FLT_MAX;
          const bool ok = child != 0 && k < FLT_MAX;
          key[c] = ok ? k : FLT_MAX;
          ch[c] = ok ? child : 0;
        }
      }
      int next;
      if constexpr (ANY_HIT) {
        next = 0;
#pragma unroll
        for (int c = A - 1; c >= 0; --c) next = ch[c] != 0 ? ch[c] : next;
      } else if constexpr (SORT) {
        bool unused[A] = {};
        sort_children<A>(key, ch, unused);
        next = ch[0];
      } else {
        float bk = key[0];
        next = ch[0];
#pragma unroll
        for (int c = 1; c < A; ++c) {
          const bool sw = key[c] < bk;
          bk = sw ? key[c] : bk;
          next = sw ? ch[c] : next;
        }
      }
      // PF: the next pop is the chosen child, else the peek (nothing is
      // pushed when no child counts)
      if constexpr (PF) prefetch_entry<M>(a, next != 0 ? next : peek);
#pragma unroll
      for (int c = A - 1; c >= 0; --c) {
        if (ch[c] != 0 && ch[c] != next) stack[sp++] = ch[c];
      }
      if (next == 0) {
        next = peek;
        sp -= sp > 0 ? 1 : 0;
      }
      code = next;
    }
    // leaf pops while the next pop is a Tri row: the row's continuation,
    // else the peek
    while (code < 0) {
      if constexpr (COUNT) {
        ++pops;
        ++leaf_pops;
      }
      const int below = stack[sp > 0 ? sp - 1 : 0];
      const int peek = sp > 0 ? below : 0;
      const float* row = a.tris + (long long)(~code) * (14 * M);
      const int* rowi = reinterpret_cast<const int*>(row);
      const float4* rowv = reinterpret_cast<const float4*>(row);
      int next = __ldg(rowi + 12 * M + M - 1) < 0 ? 0 : code - 1;
      // PF: the continuation, else the peek, before the lane loop
      if constexpr (PF) prefetch_entry<M>(a, next != 0 ? next : peek);
      const float t_test = t;
      bool found = false;
#pragma unroll 1
      for (int q = 0; q < M / kLeafLanes; ++q) {
        float4 x[13];
#pragma unroll
        for (int k = 0; k < 13; ++k)
          x[k] = __ldg(rowv + k * (M / kLeafLanes) + q);
#pragma unroll
        for (int j = 0; j < kLeafLanes; ++j) {
          const int pid = __float_as_int(lane_of(x[12], j));
          if (pid == -1) continue;
          float f[12];
#pragma unroll
          for (int k = 0; k < 12; ++k) f[k] = lane_of(x[k], j);
          if (mt_lane(f, r, t_test, t, t, u, v)) {
            prim = pid & 0x7FFFFFFF;
            geom = __ldg(rowi + 13 * M + kLeafLanes * q + j);
            found = true;
          }
        }
      }
      if (ANY_HIT && found) {  // the ray ends: leave both loops
        code = 0;
        break;
      }
      if (next == 0) {
        next = peek;
        sp -= sp > 0 ? 1 : 0;
      }
      code = next;
    }
  }
  a.t[i] = t;
  a.u[i] = u;
  a.v[i] = v;
  a.prim[i] = prim;
  a.geom[i] = geom;
  if constexpr (COUNT) {
    a.pops[i] = pops;
    a.leaf_pops[i] = leaf_pops;
  }
}

template <bool AH, int M, int S, bool SORT, bool FMA, bool COUNT, bool PF>
int launch(const Args& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.n + kBlock - 1) / kBlock);
  bvh_ct_kernel<AH, 8, M, S, SORT, FMA, COUNT, PF>
      <<<grid, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool AH, bool SORT, bool FMA, bool COUNT, bool PF>
int by_shape(const Args& a, int arity, int m, int cap, cudaStream_t s) {
  if (arity != 8) return (int)cudaErrorInvalidValue;
  switch (m * 1000 + cap) {
    case 8064: return launch<AH, 8, 64, SORT, FMA, COUNT, PF>(a, s);
    case 8128: return launch<AH, 8, 128, SORT, FMA, COUNT, PF>(a, s);
    case 12064: return launch<AH, 12, 64, SORT, FMA, COUNT, PF>(a, s);
    case 12128: return launch<AH, 12, 128, SORT, FMA, COUNT, PF>(a, s);
    case 16064: return launch<AH, 16, 64, SORT, FMA, COUNT, PF>(a, s);
    case 16128: return launch<AH, 16, 128, SORT, FMA, COUNT, PF>(a, s);
    case 24064: return launch<AH, 24, 64, SORT, FMA, COUNT, PF>(a, s);
    case 24128: return launch<AH, 24, 128, SORT, FMA, COUNT, PF>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool FMA, bool COUNT, bool PF>
int by_mode(const Args& a, int any_hit, int sort, int arity, int m, int cap,
            cudaStream_t s) {
  if (any_hit)
    return by_shape<true, false, FMA, COUNT, PF>(a, arity, m, cap, s);
  if (sort) return by_shape<false, true, FMA, COUNT, PF>(a, arity, m, cap, s);
  return by_shape<false, false, FMA, COUNT, PF>(a, arity, m, cap, s);
}

}  // namespace

// The C entry for ctypes. rays points to 11 device pointers (inv_dir xyz,
// org xyz, dir xyz, tmin, tmax), each to n floats; pops and leaf_pops are
// (n,) int32 outputs, or both null for the kernel without counters; sort:
// 1 for Batcher's network, 0 for the min-fold (closest-hit; any-hit takes
// 0); fma: 1 for the fused slab; prefetch: 1 for K7-PF (without
// counters). Launches on `stream`, never synchronizes or allocates, and
// returns cudaGetLastError() after the launch (0 = success);
// cudaErrorInvalidValue for a shape that is not instantiated and for the
// prefetch with counters.
extern "C" int rt_bvh_traverse_ct(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int arity, int packet, int any_hit, int stack_cap,
    float* t, float* u, float* v, int* prim, int* geom, int* pops,
    int* leaf_pops, int sort, int fma, int prefetch, void* stream) {
  if (n <= 0) return 0;
  if ((pops == nullptr) != (leaf_pops == nullptr) || (any_hit && sort) ||
      (prefetch && pops != nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{nodes, tris,
               rays[0], rays[1], rays[2], rays[3], rays[4], rays[5],
               rays[6], rays[7], rays[8], rays[9], rays[10],
               n, t, u, v, prim, geom, pops, leaf_pops};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prefetch)
    return fma ? by_mode<true, false, true>(a, any_hit, sort, arity, packet,
                                            stack_cap, s)
               : by_mode<false, false, true>(a, any_hit, sort, arity, packet,
                                             stack_cap, s);
  const bool count = pops != nullptr;
  if (fma)
    return count ? by_mode<true, true, false>(a, any_hit, sort, arity,
                                              packet, stack_cap, s)
                 : by_mode<true, false, false>(a, any_hit, sort, arity,
                                               packet, stack_cap, s);
  return count ? by_mode<false, true, false>(a, any_hit, sort, arity, packet,
                                             stack_cap, s)
               : by_mode<false, false, false>(a, any_hit, sort, arity,
                                              packet, stack_cap, s);
}
