// K1: BVH traversal for Hopper (sm_90a), one thread per ray, and its two
// compile-time variants K2 (next-pop L2 prefetch) and K3 (pop counters).
//
// K1 replaces the Pallas bodies _kernel_ct and _kernel_multi of
// rodent_tpu/traversal/pallas_packet.py (:878-1131, :1132-1391), which
// walk a tile of rays with ONE shared stack. This kernel computes the
// same closest-hit / any-hit result with the reference's own GPU mapping
// instead (gpu_traverse_single, SURVEY.md §1 L2): every thread owns one
// ray and its own stack.
//
// Per pop:
//   node: read the row (7A floats, __ldg) and slab-test every child in
//         the NaN-free form (bound - org) * inv_dir (api._node_test); for
//         closest-hit sort the hit children by entry distance with the
//         Batcher network and push them far-to-near, so the nearest is
//         popped next; any-hit pushes them in slot order.
//   leaf: sign-trick Moller-Trumbore over the M lanes of a Tri-M row
//         (pallas_packet.py:352-392): a lane passes `t <= t_cur` (t_cur as
//         the pop began) and updates on the strict `t < t_cur`, lanes in
//         ascending order, so of two equal hits the first one found is
//         kept; pid == -1 lanes are padding; the output id is
//         pid & 0x7FFFFFFF; the leaf continues with code - 1 while lane
//         M-1's pid sign bit is clear. Any-hit ends the ray at the first
//         leaf that hits.
// The plain torch version (rodent_tpu_torch/traversal/api.py,
// traverse_components) follows the same rules in the same float operation
// order; built with -fmad=false, the two agree bit for bit.
//
// The stack holds STACK entries, a compile-time cap the wrapper picks from
// the tree's worst case (BvhMeta.shared_stack + 2) and never exceeds.
//
// What bounds it on this card: the pops of a ray form a chain of dependent
// row loads (each row's address comes from the previous pop), so a warp
// waits on memory latency rather than bandwidth; and the 32 rays of a warp
// take different paths through the tree, so their node and leaf pops
// serialize (divergence). Sorting the rays (traversal/sorting.py) makes
// neighbouring threads walk similar paths. This first version keeps the
// stack in local memory (L1-resident) and reads rows through the
// read-only cache; there is no matrix product here, so no wgmma.
//
// K2 (kPrefetch) replaces _pf_helpers (pallas_packet.py:96-219) and the
// tris_hbm / nodes_hbm transport of the three Pallas bodies. On the TPU a
// big scene's Tri table does not fit VMEM, and each leaf pop DMAs one row
// from HBM; _pf_helpers predicts the exact next pop and starts its DMA
// before the current pop's arithmetic. On the H100 the fast memory is the
// 50 MB L2: powerplant-4.3M's Tri24 table is 300 MB, so a leaf pop that
// misses L2 waits a full HBM round trip at the head of the dependent
// chain, while its 6 MB node table stays L2-resident. K2 computes the same
// exact next pop (_next_top, :222-228):
//   after a leaf: code - 1 while lane M-1's pid sign bit is clear, else
//                 the stack peek -- known as soon as that one pid is read,
//                 so the fetch flies during the row's M-lane MT loop;
//   after a node: the nearest hit child (the one pushed last, popped
//                 next), else the peek -- known after the slab tests, so
//                 the fetch overlaps the push and the next pop's set-up;
// and, when that pop is a leaf, prefetches its whole Tri row into L2 with
// one `prefetch.global.L2` per 128-byte line (12 for a 1,344 B Tri24 row),
// as the tris_hbm transport fetches Tri rows only. The TPU's two-slot VMEM
// buffer is not carried over: one Tri24 row per thread in shared memory
// would take 172 KB per 128-thread block for a single slot, and the
// thread's own loads then hit L2 (or L1) instead. The prefetch changes only
// when bytes reach L2, never the arithmetic, so K2's hits are bit-identical
// to K1's.
//
// Measured on an H100 against K1 built the same way, on powerplant-4.3M
// (PERF.md, PR 2): this design lost 2-9% on sorted rays and unsorted ao
// rays and won 0.6% on unsorted bounce rays, and the others did no
// better. Tri rows alone beat Tri and node rows by up to 3% (the node
// prefetch only adds instructions for rows already in L2), and one
// `cp.async.bulk.prefetch.L2.global` per row through the copy engine came
// within 2% of the per-line form, either way. What
// bounds K2: with 48 registers per thread about 40 warps share an SM, so
// the scheduler already hides most of a row load's latency behind other
// warps, and a sorted ray pops 13 entries of which only 1.6 are leaves;
// the 12 prefetch instructions of a leaf are added work with little
// latency left to hide.
//
// K3 (kCount) is K1 plus the per-ray pop counters of the legacy Pallas
// body _kernel's count_pops (pallas_packet.py:419, :690-699, :870-875):
// every retired stack entry, and the leaf entries alone. Attribution only;
// the render path never launches it.
//
// K2 and K3 are instantiated for BVH8 with Tri4/8/16/24 rows only (the
// builds that use them); the C entries return cudaErrorInvalidValue for
// the rest and the wrapper raises before that.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;

// kernel variants (a template argument: each is its own instantiation)
constexpr int kPlain = 0;     // K1
constexpr int kPrefetch = 1;  // K2: exact next-pop L2 prefetch
constexpr int kCount = 2;     // K3: per-ray pop counters

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
  int* pops;       // K3 only: (n,) retired entries per ray
  int* leaf_pops;  // K3 only: (n,) leaf entries per ray
};

// Prefetches the `bytes` at p into L2, one `prefetch.global.L2` per
// 128-byte line (the last one covers a row that ends on a fresh line); the
// thread does not wait for them.
__device__ __forceinline__ void prefetch_l2(const float* p, unsigned bytes) {
  const char* c = reinterpret_cast<const char*>(p);
  for (unsigned off = 0; off < bytes; off += 128) {
    asm volatile("prefetch.global.L2 [%0];" :: "l"(c + off));
  }
  asm volatile("prefetch.global.L2 [%0];" :: "l"(c + bytes - 1));
}

// K2: when stack entry `code` (the exact next pop; 0 = none) is a leaf,
// start bringing its Tri row into L2.
template <int M>
__device__ __forceinline__ void prefetch_entry(const Args& a, int code) {
  if (code < 0) prefetch_l2(a.tris + (long long)(~code) * (14 * M), 56 * M);
}

template <int A>
__device__ __forceinline__ void cswap(float (&key)[A], int (&ch)[A],
                                      bool (&hit)[A], int i, int j) {
  const bool s = key[i] > key[j];
  const float ki = s ? key[j] : key[i];
  const float kj = s ? key[i] : key[j];
  const int ci = s ? ch[j] : ch[i];
  const int cj = s ? ch[i] : ch[j];
  const bool hi = s ? hit[j] : hit[i];
  const bool hj = s ? hit[i] : hit[j];
  key[i] = ki; key[j] = kj;
  ch[i] = ci; ch[j] = cj;
  hit[i] = hi; hit[j] = hj;
}

// Batcher odd-even merge networks, ascending (api._SORT_NETWORKS)
template <int A>
__device__ __forceinline__ void sort_children(float (&key)[A], int (&ch)[A],
                                              bool (&hit)[A]) {
  if constexpr (A == 2) {
    cswap<A>(key, ch, hit, 0, 1);
  } else if constexpr (A == 4) {
    cswap<A>(key, ch, hit, 0, 1); cswap<A>(key, ch, hit, 2, 3);
    cswap<A>(key, ch, hit, 0, 2); cswap<A>(key, ch, hit, 1, 3);
    cswap<A>(key, ch, hit, 1, 2);
  } else {
    static_assert(A == 8, "arity must be 2, 4 or 8");
    cswap<A>(key, ch, hit, 0, 1); cswap<A>(key, ch, hit, 2, 3);
    cswap<A>(key, ch, hit, 4, 5); cswap<A>(key, ch, hit, 6, 7);
    cswap<A>(key, ch, hit, 0, 2); cswap<A>(key, ch, hit, 1, 3);
    cswap<A>(key, ch, hit, 4, 6); cswap<A>(key, ch, hit, 5, 7);
    cswap<A>(key, ch, hit, 1, 2); cswap<A>(key, ch, hit, 5, 6);
    cswap<A>(key, ch, hit, 0, 4); cswap<A>(key, ch, hit, 1, 5);
    cswap<A>(key, ch, hit, 2, 6); cswap<A>(key, ch, hit, 3, 7);
    cswap<A>(key, ch, hit, 2, 4); cswap<A>(key, ch, hit, 3, 5);
    cswap<A>(key, ch, hit, 1, 2); cswap<A>(key, ch, hit, 3, 4);
    cswap<A>(key, ch, hit, 5, 6);
  }
}

template <bool ANY_HIT, int A, int M, int STACK, int VAR>
__global__ void __launch_bounds__(kBlock) bvh_traverse_kernel(Args a) {
  constexpr bool PF = VAR == kPrefetch;
  constexpr bool COUNT = VAR == kCount;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const float ix = a.ix[i], iy = a.iy[i], iz = a.iz[i];
  const float ox = a.ox[i], oy = a.oy[i], oz = a.oz[i];
  const float dx = a.dx[i], dy = a.dy[i], dz = a.dz[i];
  const float tmin = a.tmin[i], tmax = a.tmax[i];

  float t = tmax, u = 0.0f, v = 0.0f;
  int prim = -1, geom = -1;
  int stack[STACK];
  int sp = 0;
  int pops = 0, leaf_pops = 0;        // K3's counters
  if (tmax >= tmin) stack[sp++] = 1;  // root ref; dead rays never start

  while (sp > 0) {
    const int code = stack[--sp];
    if constexpr (COUNT) {
      ++pops;
      leaf_pops += code < 0 ? 1 : 0;
    }
    if (code > 0) {
      const float* row = a.nodes + (long long)(code - 1) * (7 * A);
      float key[A];
      int ch[A];
      bool hit[A];
#pragma unroll
      for (int c = 0; c < A; ++c) {
        const float tx0 = (__ldg(row + 0 * A + c) - ox) * ix;
        const float tx1 = (__ldg(row + 1 * A + c) - ox) * ix;
        const float ty0 = (__ldg(row + 2 * A + c) - oy) * iy;
        const float ty1 = (__ldg(row + 3 * A + c) - oy) * iy;
        const float tz0 = (__ldg(row + 4 * A + c) - oz) * iz;
        const float tz1 = (__ldg(row + 5 * A + c) - oz) * iz;
        const float entry = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                  fmaxf(fminf(tz0, tz1), tmin));
        const float exit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                 fminf(fmaxf(tz0, tz1), t));
        ch[c] = __float_as_int(__ldg(row + 6 * A + c));
        hit[c] = (entry <= exit) && (ch[c] != 0);
        key[c] = hit[c] ? entry : INFINITY;
      }
      if (!ANY_HIT) sort_children<A>(key, ch, hit);
      int k = 0;
#pragma unroll
      for (int c = 0; c < A; ++c) k += hit[c] ? 1 : 0;
      if constexpr (PF) {
        // the next pop: the first hit child in push order ends on top;
        // with no hit child, the entry below the one just popped
        int nxt = sp > 0 ? stack[sp - 1] : 0;
#pragma unroll
        for (int c = A - 1; c >= 0; --c) nxt = hit[c] ? ch[c] : nxt;
        prefetch_entry<M>(a, nxt);
      }
      int rank = 0;
#pragma unroll
      for (int c = 0; c < A; ++c) {
        if (hit[c]) {
          stack[sp + k - 1 - rank] = ch[c];  // first in order ends on top
          ++rank;
        }
      }
      sp += k;
    } else {
      const float* row = a.tris + (long long)(~code) * (14 * M);
      const int* rowi = reinterpret_cast<const int*>(row);
      const float t_test = t;
      bool found = false;
      if constexpr (PF) {
        // the continuation is known from lane M-1's pid alone: start the
        // next row's fetch before the M-lane intersection loop
        const bool last = __ldg(rowi + 12 * M + M - 1) < 0;
        prefetch_entry<M>(a, !last ? code - 1
                                   : (sp > 0 ? stack[sp - 1] : 0));
      }
#pragma unroll 4
      for (int l = 0; l < M; ++l) {
        const int pid = __ldg(rowi + 12 * M + l);
        if (pid == -1) continue;
        const float cx = __ldg(row + 0 * M + l) - ox;
        const float cy = __ldg(row + 1 * M + l) - oy;
        const float cz = __ldg(row + 2 * M + l) - oz;
        const float e1x = __ldg(row + 3 * M + l);
        const float e1y = __ldg(row + 4 * M + l);
        const float e1z = __ldg(row + 5 * M + l);
        const float e2x = __ldg(row + 6 * M + l);
        const float e2y = __ldg(row + 7 * M + l);
        const float e2z = __ldg(row + 8 * M + l);
        const float nx = __ldg(row + 9 * M + l);
        const float ny = __ldg(row + 10 * M + l);
        const float nz = __ldg(row + 11 * M + l);
        const float rx = dy * cz - dz * cy;
        const float ry = dz * cx - dx * cz;
        const float rz = dx * cy - dy * cx;
        const float det = nx * dx + ny * dy + nz * dz;
        const float abs_det = fabsf(det);
        const float sign = det < 0.0f ? -1.0f : 1.0f;
        const float uu = (rx * e2x + ry * e2y + rz * e2z) * sign;
        const float vv = (rx * e1x + ry * e1y + rz * e1z) * sign;
        const float tt = (cx * nx + cy * ny + cz * nz) * sign;
        const bool ok = (uu >= 0.0f) && (vv >= 0.0f) &&
                        (uu + vv <= abs_det) && (abs_det != 0.0f) &&
                        (tt >= abs_det * tmin) && (tt <= abs_det * t_test);
        const float inv_det = 1.0f / (abs_det != 0.0f ? abs_det : 1.0f);
        const float tv = tt * inv_det;
        if (ok && tv < t) {
          t = tv;
          u = uu * inv_det;
          v = vv * inv_det;
          prim = pid & 0x7FFFFFFF;
          geom = __ldg(rowi + 13 * M + l);
          found = true;
        }
      }
      if (__ldg(rowi + 12 * M + M - 1) >= 0) stack[sp++] = code - 1;
      if (ANY_HIT && found) break;
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

template <int VAR, bool AH, int A, int M, int S>
int launch(const Args& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.n + kBlock - 1) / kBlock);
  bvh_traverse_kernel<AH, A, M, S, VAR><<<grid, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int VAR, bool AH, int A, int M>
int by_stack(const Args& a, int cap, cudaStream_t s) {
  switch (cap) {
    case 64: return launch<VAR, AH, A, M, 64>(a, s);
    case 128: return launch<VAR, AH, A, M, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1: every arity and packet width the builder makes
template <bool AH, int A>
int by_packet(const Args& a, int m, int cap, cudaStream_t s) {
  switch (m) {
    case 1: return by_stack<kPlain, AH, A, 1>(a, cap, s);
    case 4: return by_stack<kPlain, AH, A, 4>(a, cap, s);
    case 8: return by_stack<kPlain, AH, A, 8>(a, cap, s);
    case 16: return by_stack<kPlain, AH, A, 16>(a, cap, s);
    case 24: return by_stack<kPlain, AH, A, 24>(a, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool AH>
int by_arity(const Args& a, int arity, int m, int cap, cudaStream_t s) {
  switch (arity) {
    case 2: return by_packet<AH, 2>(a, m, cap, s);
    case 4: return by_packet<AH, 4>(a, m, cap, s);
    case 8: return by_packet<AH, 8>(a, m, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 and K3: BVH8 with Tri4/8/16/24 rows only
template <int VAR, bool AH>
int wide(const Args& a, int arity, int m, int cap, cudaStream_t s) {
  if (arity != 8) return (int)cudaErrorInvalidValue;
  switch (m) {
    case 4: return by_stack<VAR, AH, 8, 4>(a, cap, s);
    case 8: return by_stack<VAR, AH, 8, 8>(a, cap, s);
    case 16: return by_stack<VAR, AH, 8, 16>(a, cap, s);
    case 24: return by_stack<VAR, AH, 8, 24>(a, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const float* nodes, const float* tris,
               const float* const* rays, long long n, float* t, float* u,
               float* v, int* prim, int* geom, int* pops, int* leaf_pops) {
  return Args{nodes, tris,
              rays[0], rays[1], rays[2], rays[3], rays[4], rays[5],
              rays[6], rays[7], rays[8], rays[9], rays[10],
              n, t, u, v, prim, geom, pops, leaf_pops};
}

}  // namespace

// Plain C entries for ctypes. rays points to 11 device pointers (inv_dir
// xyz, org xyz, dir xyz, tmin, tmax), each to n floats. Each launches on
// `stream`, never synchronizes or allocates, and returns
// cudaGetLastError() after the launch (0 = success).

// K1
extern "C" int rt_bvh_traverse(const float* nodes, const float* tris,
                               const float* const* rays, long long n,
                               int arity, int packet, int any_hit,
                               int stack_cap, float* t, float* u, float* v,
                               int* prim, int* geom, void* stream) {
  if (n <= 0) return 0;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom,
                           nullptr, nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? by_arity<true>(a, arity, packet, stack_cap, s)
                 : by_arity<false>(a, arity, packet, stack_cap, s);
}

// K2: K1's arguments
extern "C" int rt_bvh_traverse_prefetch(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int arity, int packet, int any_hit, int stack_cap,
    float* t, float* u, float* v, int* prim, int* geom, void* stream) {
  if (n <= 0) return 0;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom,
                           nullptr, nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? wide<kPrefetch, true>(a, arity, packet, stack_cap, s)
                 : wide<kPrefetch, false>(a, arity, packet, stack_cap, s);
}

// K3: K1's arguments plus two (n,) int32 counter outputs
extern "C" int rt_bvh_traverse_count(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int arity, int packet, int any_hit, int stack_cap,
    float* t, float* u, float* v, int* prim, int* geom, int* pops,
    int* leaf_pops, void* stream) {
  if (n <= 0) return 0;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom,
                           pops, leaf_pops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? wide<kCount, true>(a, arity, packet, stack_cap, s)
                 : wide<kCount, false>(a, arity, packet, stack_cap, s);
}
