// K1: BVH traversal for Hopper (sm_90a), one thread per ray, and its
// compile-time variants K2 (next-pop L2 prefetch), K3 (pop counters) and
// K4 (the options of the legacy Pallas body, built with -DRT_OPTIONS into
// a second library), and a second body of K1-K3, the group stack (built
// with -DRT_GROUP into a library of the measurements only).
//
// K1 replaces the Pallas body _kernel_multi of
// rodent_tpu/traversal/pallas_packet.py (:1132-1391), the legacy order the
// JAX renderers run, which walks tiles of rays with ONE shared stack each;
// its carry-top body _kernel_ct (:878-1131) is K7's (csrc/bvh_ct.cu). This
// kernel computes the same result with the reference's own GPU mapping
// (gpu_traverse_single, SURVEY.md §1 L2): each thread one ray and a stack.
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
// the tree's worst case (BvhMeta.shared_stack + 2) and never exceeds: one
// int entry per hit child and per leaf continuation.
//
// What bounds it on this card: the pops of a ray form a chain of dependent
// row loads (each row's address comes from the previous pop), and the 32
// rays of a warp take different paths through the tree, so their node and
// leaf pops serialize (divergence); sorting the rays (traversal/sorting.py)
// makes neighbouring threads walk similar paths. Registers bind
// occupancy: 47-48 a thread hold 40 warps per SM. The stack is indexed
// dynamically, so it lives in local memory (L1-resident): one 4-byte store
// and load per pop. There is no matrix product here, so no wgmma.
//
// The group stack (bvh_group_kernel, -DRT_GROUP) is a second body of K1,
// K2 and K3 that pops the same entries in the same order, so it returns
// the same bits and counts the same pops, with one stack entry per
// expanded node instead of one per hit child. A node's first hit child,
// whose code rides through the sort beside its slot, and a leaf's next row
// are the next pop through a register. The node's other hit children form
// the current group: the node's row index and their slots, 3 bits each in
// visit order, with their count, kept in registers; a pop takes the next
// slot and re-reads that child's code from the node row (most often an L1
// hit). Expanding a node with two or more hit children pushes the current
// group, if it still has slots, as one 64-bit word. The stack holds proper
// ancestors of the current group's node, one entry each, so the tree's
// depth bounds it exactly (experiments/ab_body.py group_cap: 16 or 64
// entries). Its library holds both bodies, which experiments/ab_body.py
// and chip_smoke.py phase 14 time in turns. On the card the group stack
// ran within a few percent of the first body, ahead on incoherent rays and
// behind at both render widths (PERF.md): the stack's traffic is not
// what bounds K1, and the renderers keep the first body.
//
// K2 (kPrefetch) replaces _pf_helpers (pallas_packet.py:96-219) and the
// tris_hbm / nodes_hbm transport of the legacy Pallas bodies (the
// carry-top body's is K7-PF, csrc/bvh_ct.cu). On the TPU a
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
// (in the group stack: the register `next`, else the current group's next
// slot, else the top group's first slot), and, when that pop is a leaf,
// prefetches its whole Tri row into L2 with
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
// K1 is instantiated for arity 2/4/8 with Tri1/4/8/12/16/24 rows, K2 and
// K3 for BVH8 with Tri4/8/12/16/24 rows only (the builds that use them):
// the main library's 112 kernels (72 of K1, 20 each of K2 and K3; 224 in
// the group library, which holds both bodies). The C entries return
// cudaErrorInvalidValue for the rest and the wrapper raises before that.
//
// K4 (bvh_traverse_option_kernel, -DRT_OPTIONS) is K3 with one option of
// the legacy body _kernel (pallas_packet.py:395-876) compiled in, or with
// none (kBase), so each option is timed against the base and against K3
// with the same counting overhead. The options are the TPU's levers against
// the per-pop dependent chain; on this card the same chain (a row load
// whose address comes from the previous pop) and warp divergence bound K1,
// so each is asked again here:
//   kBase        no option: K3's pops in K3's order on K4's loop; every
//                output is K3's, bit for bit.
//   kNoNodeTest  ablate "nonodetest" (:575-578): push every nonzero child
//                in slot order without a slab test; hits stay right, pops
//                grow; the time per pop without the 8 slab tests.
//   kNoLeafTest  ablate "noleaftest" (:639-644): a leaf skips its M lanes
//                and follows its continuation; every ray misses; the time
//                per pop without Moller-Trumbore.
//   kNoSort      ablate "nosort" (:548, :582, :773), closest-hit only:
//                hit children pushed in slot order, no Batcher network.
//   kPops2       pops=2, the phased body (:679-789): pop two entries, test
//                both against t as the iteration began, merge the two leaf
//                folds first-wins with strict <, push the second entry's
//                children first. Two node rows are expanded in one basic
//                block, so both rows' loads are in flight at once: the
//                thread waits on one latency for two pops.
//   kChain2/4    leaf_chain 2 and 4 (:651-663): one pop consumes up to N
//                consecutive Tri rows of a leaf in registers, with no
//                stack store or load between them; still one pop and one
//                leaf pop on the counters.
//   kRowLoads    the counterpart of scalar_reads (:449-460). K1 and the
//                base read each field with its own __ldg, which is what
//                scalar_reads=True was on the TPU; this option reads rows
//                as K7 does (bvh_ct.cu): a node row (224 B for BVH8) as 14
//                16-byte ld.global.nc.v4.f32 loads, and a Tri row's fields
//                four lanes at a time (rows are laid out by field, so four
//                lanes of a field are contiguous; rows are 28A and 56M
//                bytes, so 16-byte aligned), 13 loads a group of four
//                lanes and the geometry id alone where a lane hits. Fewer,
//                wider loads per pop; it changes no bit of K3's output.
// The other options keep the base's scalar loads, so each is one lever
// against the base, and row_loads against K3 is the loop and the loads
// together.
//
// The loop is a while-while loop, as K7's (bvh_ct.cu): an outer loop over
// two inner ones, node pops while a ray's popped entry is a node, then
// leaf pops while it is a Tri row. A warp runs a path whenever any of its
// rays takes it; in K3's if-if form a warp whose rays are split between
// node and leaf pops runs both paths in one trip, here a ray that holds a
// leaf waits in the node loop until every ray of the warp holds one or is
// done. The order is K3's, the legacy one: a node pushes its hit children
// far-to-near after the Batcher network, a leaf pushes its continuation,
// and every pop takes the stack's top. Each ray pops the same entries in
// the same order with the same t and stack as in K3's loop, so hits and
// both counters are unchanged.
// kPops2 runs its pairs on the same loop: each trip of either inner loop
// is one iteration of the phased body and pops the stack's top two
// entries. Its node loop runs while both are node rows (the two-row
// block), its other loop while one is a Tri row or the stack held one
// entry. Either pops the pair the if-if body pops from the same stack, so
// the pairing, and both counters, stay the plain version's.
// Measured in turns against the if-if body this loop replaced (PERF.md),
// on 1M sorted primaries: 0.75-0.92x for nonodetest, nosort, the chains
// and row_loads, 1.01-1.03x for kPops2, 1.05-1.25x for noleaftest, whose
// leaf pop is one load; the base ran 0.92-0.94x K3. On 65,536 any-hit
// rays (512 blocks, under one wave), timed as CUDA-graph replays, the
// base ran 0.96-1.09x K3 by ray set and round, row_loads 0.62-0.73x K3,
// and kPops2 1.04-1.52x the if-if body.
//
// The octant-pure ordered slab test (ablation "nopure", :794-799) and the
// row-frustum test (frustum=True, :493-550) belong to one stack shared by
// a tile of rays: they are K5's (bvh_tile.cu), not K4's. K4 is
// instantiated for BVH8 x Tri8/Tri24 x stack 64/128 x closest/any-hit
// (kNoSort closest-hit only): 60 kernels, 8 of them the base's. Stacks of
// 64/128 hold the tree's worst case for one pop a trip (the wrapper's
// stack_cap, K1's), so only kPops2 checks its pushes. It takes stacks of
// 128/256: expanding the second entry early leaves up to A more entries
// per level, and the wrapper sizes it at twice the pops=1 worst case, a
// bound that is not proven. A kPops2 stack that would overflow is never
// written past; the ray stops and its pop counter reads -1.

#include <cuda_runtime.h>
#include <math.h>

#include "bvh_common.cuh"  // Ray, sort_children, mt_lane

namespace {

constexpr int kBlock = 128;

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
  int* pops;       // K3, K4: (n,) retired entries per ray
  int* leaf_pops;  // K3, K4: (n,) leaf entries per ray
};

__device__ __forceinline__ Ray load_ray(const Args& a, long long i) {
  return Ray{a.ix[i], a.iy[i], a.iz[i], a.ox[i], a.oy[i], a.oz[i],
             a.dx[i], a.dy[i], a.dz[i], a.tmin[i]};
}

// Slab tests of every child of one node row; ld(j) reads float j of the
// row. Fills the child codes, the hit mask (entry <= exit, nonzero child)
// and the sort key (entry distance; +inf for a miss).
template <int A, typename Ld>
__device__ __forceinline__ void slab_test(Ld ld, const Ray& r, float t_cur,
                                          float (&key)[A], int (&ch)[A],
                                          bool (&hit)[A]) {
#pragma unroll
  for (int c = 0; c < A; ++c) {
    const float tx0 = (ld(0 * A + c) - r.ox) * r.ix;
    const float tx1 = (ld(1 * A + c) - r.ox) * r.ix;
    const float ty0 = (ld(2 * A + c) - r.oy) * r.iy;
    const float ty1 = (ld(3 * A + c) - r.oy) * r.iy;
    const float tz0 = (ld(4 * A + c) - r.oz) * r.iz;
    const float tz1 = (ld(5 * A + c) - r.oz) * r.iz;
    const float entry = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                              fmaxf(fminf(tz0, tz1), r.tmin));
    const float exit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                             fminf(fmaxf(tz0, tz1), t_cur));
    ch[c] = __float_as_int(ld(6 * A + c));
    hit[c] = (entry <= exit) && (ch[c] != 0);
    key[c] = hit[c] ? entry : INFINITY;
  }
}

#ifndef RT_OPTIONS

// kernel variants (a template argument: each is its own instantiation)
constexpr int kPlain = 0;     // K1
constexpr int kPrefetch = 1;  // K2: exact next-pop L2 prefetch
constexpr int kCount = 2;     // K3: per-ray pop counters

// the two bodies of K1, K2 and K3 (experiments/ab_body.py BODIES)
constexpr int kGroup = 0;     // one stack entry per expanded node
constexpr int kStackV1 = 1;   // the first body: one entry per hit child

// K2's prefetch of the exact next pop's Tri row, prefetch_entry, is in
// bvh_common.cuh, which K7-PF (bvh_ct.cu) shares.

template <bool ANY_HIT, int A, int M, int STACK, int VAR>
__global__ void __launch_bounds__(kBlock) bvh_traverse_kernel(Args a) {
  constexpr bool PF = VAR == kPrefetch;
  constexpr bool COUNT = VAR == kCount;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a, i);
  const float tmax = a.tmax[i];

  float t = tmax, u = 0.0f, v = 0.0f;
  int prim = -1, geom = -1;
  int stack[STACK];
  int sp = 0;
  int pops = 0, leaf_pops = 0;          // K3's counters
  if (tmax >= r.tmin) stack[sp++] = 1;  // root ref; dead rays never start

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
      slab_test<A>([&](int j) { return __ldg(row + j); }, r, t, key, ch,
                   hit);
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
        float f[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) f[k] = __ldg(row + k * M + l);
        if (mt_lane(f, r, t_test, t, t, u, v)) {
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

#ifdef RT_GROUP

// The child code in `slot` of node row `node` (0-based).
template <int A>
__device__ __forceinline__ int child_code(const Args& a, int node,
                                          unsigned slot) {
  return __float_as_int(
      __ldg(a.nodes + (long long)node * (7 * A) + 6 * A + slot));
}

// A group: a node's row index and the hit slots of its children still to
// visit, in visit order, 3 bits a slot from the low end (at most 8 x 3 =
// 24 bits) with their count in bits 24-27 of `hi`; on the stack as one
// 64-bit word, the row index low. hi == 0 is the empty group.
struct Group {
  int node;
  unsigned hi;
};

__device__ __forceinline__ unsigned long long pack_group(const Group& g) {
  return (unsigned long long)(unsigned)g.node |
         (unsigned long long)g.hi << 32;
}

__device__ __forceinline__ Group unpack_group(unsigned long long e) {
  return Group{(int)(unsigned)e, (unsigned)(e >> 32)};
}

// Takes a group's next slot: the low 3 bits go, the count drops by one.
__device__ __forceinline__ unsigned take_slot(unsigned& hi) {
  const unsigned slot = hi & 7u;
  hi = ((hi & 0xFFFFFFu) >> 3) | (((hi >> 24) - 1u) << 24);
  return slot;
}

// K2: the code of the pop that follows when no register holds it: the
// current group's next slot, else the top group's first one; 0 if none.
template <int A, int STACK>
__device__ __forceinline__ int peek_group(
    const Args& a, const Group& g, const unsigned long long (&stack)[STACK],
    int sp) {
  if (g.hi != 0) return child_code<A>(a, g.node, g.hi & 7u);
  if (sp == 0) return 0;
  const Group top = unpack_group(stack[sp - 1]);
  return child_code<A>(a, top.node, top.hi & 7u);
}

// The group-stack body. Pops come from three places, in this order: the
// register `next` (the root; a node's first hit child, whose code the sort
// carried; a leaf's next row), the current group (registers: a pop takes
// its next slot and re-reads that child's code from the node row, most
// often still in L1) and the stack of groups. Expanding a node with k hit
// children makes the first the next pop and, for k > 1, pushes the current
// group if it still has slots and makes the other k - 1 the current group.
// The entries popped, and their order, are the first body's, so the two
// return the same bits and count the same pops. The stack holds proper
// ancestors of the node whose group is current, one entry each, so it
// never holds more than the tree's depth (ab_body.compute_depth),
// which the wrapper's cap holds.
template <bool ANY_HIT, int A, int M, int STACK, int VAR>
__global__ void __launch_bounds__(kBlock) bvh_group_kernel(Args a) {
  constexpr bool PF = VAR == kPrefetch;
  constexpr bool COUNT = VAR == kCount;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a, i);
  const float tmax = a.tmax[i];

  float t = tmax, u = 0.0f, v = 0.0f;
  int prim = -1, geom = -1;
  unsigned long long stack[STACK];
  int sp = 0;
  Group g{0, 0u};                       // the current group
  int next = tmax >= r.tmin ? 1 : 0;    // root ref; dead rays never start
  int pops = 0, leaf_pops = 0;          // K3's counters

  while (true) {
    int code = next;
    next = 0;
    if (code == 0) {
      if (g.hi == 0) {
        if (sp == 0) break;
        g = unpack_group(stack[--sp]);
      }
      code = child_code<A>(a, g.node, take_slot(g.hi));
    }
    if constexpr (COUNT) {
      ++pops;
      leaf_pops += code < 0 ? 1 : 0;
    }
    if (code > 0) {
      const float* row = a.nodes + (long long)(code - 1) * (7 * A);
      float key[A];
      int ch[A];
      bool hit[A];
      slab_test<A>([&](int j) { return __ldg(row + j); }, r, t, key, ch,
                   hit);
      // each child's code and slot in one word (|code| < 2^28, host-checked)
#pragma unroll
      for (int c = 0; c < A; ++c) ch[c] = ch[c] * 8 + c;
      if (!ANY_HIT) sort_children<A>(key, ch, hit);
      // the hit slots in visit order, the first one lowest, and the first
      // hit child's code
      unsigned hi = 0u;
      int k = 0, first = 0;
#pragma unroll
      for (int c = A - 1; c >= 0; --c) {
        if (hit[c]) {
          hi = (hi << 3) | (unsigned)(ch[c] & 7);
          first = ch[c];
          ++k;
        }
      }
      if (k > 0) next = first >> 3;
      if (k > 1) {
        if (g.hi != 0) stack[sp++] = pack_group(g);
        g = Group{code - 1, (hi >> 3) | ((unsigned)(k - 1) << 24)};
      }
      if constexpr (PF)
        prefetch_entry<M>(a, next != 0 ? next
                                       : peek_group<A>(a, g, stack, sp));
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
                                   : peek_group<A>(a, g, stack, sp));
      }
#pragma unroll 4
      for (int l = 0; l < M; ++l) {
        const int pid = __ldg(rowi + 12 * M + l);
        if (pid == -1) continue;
        float f[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) f[k] = __ldg(row + k * M + l);
        if (mt_lane(f, r, t_test, t, t, u, v)) {
          prim = pid & 0x7FFFFFFF;
          geom = __ldg(rowi + 13 * M + l);
          found = true;
        }
      }
      if (__ldg(rowi + 12 * M + M - 1) >= 0) next = code - 1;
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

#endif  // RT_GROUP

// Launches one instantiation of body BODY on a.n rays, or, with occ,
// writes its resident blocks per SM there instead and launches nothing.
template <int BODY, int VAR, bool AH, int A, int M, int S>
int launch(const Args& a, cudaStream_t stream, int* occ) {
  void (*kernel)(Args);
#ifdef RT_GROUP
  if constexpr (BODY == kGroup)
    kernel = bvh_group_kernel<AH, A, M, S, VAR>;
  else
#endif
    kernel = bvh_traverse_kernel<AH, A, M, S, VAR>;
  if (occ)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel,
                                                              kBlock, 0);
  const unsigned grid = (unsigned)((a.n + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the compiled stacks: the first body's entries (traversal/packet.py
// STACK_CAPS), groups (experiments/ab_body.py GROUP_CAPS)
template <int BODY, int VAR, bool AH, int A, int M>
int by_stack(const Args& a, int cap, cudaStream_t s, int* occ) {
  if constexpr (BODY == kGroup) {
    switch (cap) {
      case 16: return launch<BODY, VAR, AH, A, M, 16>(a, s, occ);
      case 64: return launch<BODY, VAR, AH, A, M, 64>(a, s, occ);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (cap) {
      case 64: return launch<BODY, VAR, AH, A, M, 64>(a, s, occ);
      case 128: return launch<BODY, VAR, AH, A, M, 128>(a, s, occ);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

// K1: every arity, with the Tri widths the repository's builds use (the
// builder makes any width; the others are refused)
template <int BODY, bool AH, int A>
int by_packet(const Args& a, int m, int cap, cudaStream_t s, int* occ) {
  switch (m) {
    case 1: return by_stack<BODY, kPlain, AH, A, 1>(a, cap, s, occ);
    case 4: return by_stack<BODY, kPlain, AH, A, 4>(a, cap, s, occ);
    case 8: return by_stack<BODY, kPlain, AH, A, 8>(a, cap, s, occ);
    case 12: return by_stack<BODY, kPlain, AH, A, 12>(a, cap, s, occ);
    case 16: return by_stack<BODY, kPlain, AH, A, 16>(a, cap, s, occ);
    case 24: return by_stack<BODY, kPlain, AH, A, 24>(a, cap, s, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int BODY, bool AH>
int by_arity(const Args& a, int arity, int m, int cap, cudaStream_t s,
             int* occ) {
  switch (arity) {
    case 2: return by_packet<BODY, AH, 2>(a, m, cap, s, occ);
    case 4: return by_packet<BODY, AH, 4>(a, m, cap, s, occ);
    case 8: return by_packet<BODY, AH, 8>(a, m, cap, s, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 and K3: BVH8 with Tri4/8/12/16/24 rows only
template <int BODY, int VAR, bool AH>
int wide(const Args& a, int arity, int m, int cap, cudaStream_t s,
         int* occ) {
  if (arity != 8) return (int)cudaErrorInvalidValue;
  switch (m) {
    case 4: return by_stack<BODY, VAR, AH, 8, 4>(a, cap, s, occ);
    case 8: return by_stack<BODY, VAR, AH, 8, 8>(a, cap, s, occ);
    case 12: return by_stack<BODY, VAR, AH, 8, 12>(a, cap, s, occ);
    case 16: return by_stack<BODY, VAR, AH, 8, 16>(a, cap, s, occ);
    case 24: return by_stack<BODY, VAR, AH, 8, 24>(a, cap, s, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int BODY, bool AH>
int by_variant(const Args& a, int var, int arity, int m, int cap,
               cudaStream_t s, int* occ) {
  switch (var) {
    case kPlain: return by_arity<BODY, AH>(a, arity, m, cap, s, occ);
    case kPrefetch:
      return wide<BODY, kPrefetch, AH>(a, arity, m, cap, s, occ);
    case kCount: return wide<BODY, kCount, AH>(a, arity, m, cap, s, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

// one instantiation of K1, K2 or K3 (var) in body `body`; the main library
// holds the first body only
int dispatch(const Args& a, int body, int var, int arity, int m, int any_hit,
             int cap, cudaStream_t s, int* occ) {
#ifdef RT_GROUP
  if (body == kGroup)
    return any_hit ? by_variant<kGroup, true>(a, var, arity, m, cap, s, occ)
                   : by_variant<kGroup, false>(a, var, arity, m, cap, s, occ);
#endif
  if (body == kStackV1)
    return any_hit
               ? by_variant<kStackV1, true>(a, var, arity, m, cap, s, occ)
               : by_variant<kStackV1, false>(a, var, arity, m, cap, s, occ);
  return (int)cudaErrorInvalidValue;
}

#else  // RT_OPTIONS: K4

// K4's options, in the order of traversal/packet.py OPTIONS
constexpr int kNoNodeTest = 0;
constexpr int kNoLeafTest = 1;
constexpr int kNoSort = 2;
constexpr int kPops2 = 3;
constexpr int kChain2 = 4;
constexpr int kChain4 = 5;
constexpr int kRowLoads = 6;
constexpr int kBase = 7;

// the running hit of a ray
struct Hit {
  float t, u, v;
  int prim, geom;
};

// Expands one node row: the children to push (in push order) and their
// mask. NODETEST=false pushes every nonzero child in slot order; ROW reads
// the row in 16-byte loads.
template <int A, bool NODETEST, bool SORT, bool ROW>
__device__ __forceinline__ void expand_node(const float* row, const Ray& r,
                                            float t_test, int (&ch)[A],
                                            bool (&hit)[A]) {
  if constexpr (!NODETEST) {
#pragma unroll
    for (int c = 0; c < A; ++c) {
      ch[c] = __float_as_int(__ldg(row + 6 * A + c));
      hit[c] = ch[c] != 0;
    }
    return;
  } else {
    float key[A];
    if constexpr (ROW) {
      static_assert((7 * A) % 4 == 0, "row loads need 16-byte rows");
      const float4* row4 = reinterpret_cast<const float4*>(row);
      float b[7 * A];
#pragma unroll
      for (int q = 0; q < 7 * A / 4; ++q) {
        const float4 x = __ldg(row4 + q);
        b[4 * q] = x.x; b[4 * q + 1] = x.y;
        b[4 * q + 2] = x.z; b[4 * q + 3] = x.w;
      }
      slab_test<A>([&](int j) { return b[j]; }, r, t_test, key, ch, hit);
    } else {
      slab_test<A>([&](int j) { return __ldg(row + j); }, r, t_test, key,
                   ch, hit);
    }
    if constexpr (SORT) sort_children<A>(key, ch, hit);
  }
}

// Moller-Trumbore over the M lanes of one Tri row, folded into h: lanes
// test against t_test and update on a strict < against the running h.t.
// ROW reads four lanes of each field in one 16-byte load (K7's leaf).
template <int M, bool ROW>
__device__ __forceinline__ void leaf_row(const float* row, const Ray& r,
                                         float t_test, Hit& h) {
  const int* rowi = reinterpret_cast<const int*>(row);
  if constexpr (ROW) {
    static_assert(M % 4 == 0, "row loads need M a multiple of 4");
    const float4* rowv = reinterpret_cast<const float4*>(row);
#pragma unroll 1
    for (int q = 0; q < M / 4; ++q) {
      float4 x[13];
#pragma unroll
      for (int k = 0; k < 13; ++k) x[k] = __ldg(rowv + k * (M / 4) + q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pid = __float_as_int(lane_of(x[12], j));
        if (pid == -1) continue;
        float f[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) f[k] = lane_of(x[k], j);
        if (mt_lane(f, r, t_test, h.t, h.t, h.u, h.v)) {
          h.prim = pid & 0x7FFFFFFF;
          h.geom = __ldg(rowi + 13 * M + 4 * q + j);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int l = 0; l < M; ++l) {
      const int pid = __ldg(rowi + 12 * M + l);
      if (pid == -1) continue;
      float f[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) f[k] = __ldg(row + k * M + l);
      if (mt_lane(f, r, t_test, h.t, h.t, h.u, h.v)) {
        h.prim = pid & 0x7FFFFFFF;
        h.geom = __ldg(rowi + 13 * M + l);
      }
    }
  }
}

// One leaf pop: up to CHAIN consecutive Tri rows from `code`, each tested
// against t_test (t as the pop began). Returns the continuation to push
// (the next row of a leaf longer than the chain), else 0.
template <int M, int CHAIN, bool LEAFTEST, bool ROW>
__device__ __forceinline__ int leaf_pop(const Args& a, int code, const Ray& r,
                                        float t_test, Hit& h) {
#pragma unroll 1
  for (int step = 0; step < CHAIN; ++step) {
    const float* row = a.tris + (long long)(~code) * (14 * M);
    if constexpr (LEAFTEST) leaf_row<M, ROW>(row, r, t_test, h);
    const int* rowi = reinterpret_cast<const int*>(row);
    if (__ldg(rowi + 12 * M + M - 1) < 0) return 0;
    --code;
  }
  return code;
}

// Pushes the masked children so the first one in push order ends on top.
// GUARD: false, and nothing written, where they do not fit.
template <int A, int STACK, bool GUARD>
__device__ __forceinline__ bool push(int (&stack)[STACK], int& sp,
                                     const int (&ch)[A],
                                     const bool (&hit)[A]) {
  int k = 0;
#pragma unroll
  for (int c = 0; c < A; ++c) k += hit[c] ? 1 : 0;
  if (GUARD && sp + k > STACK) return false;
  int rank = 0;
#pragma unroll
  for (int c = 0; c < A; ++c) {
    if (hit[c]) {
      stack[sp + k - 1 - rank] = ch[c];
      ++rank;
    }
  }
  sp += k;
  return true;
}

// One entry of a kPops2 pair: a node's children, or a leaf pop folded into
// h with its continuation as the only child; code 0 (no second entry)
// pushes nothing.
template <int A, int M, bool ANY_HIT>
__device__ __forceinline__ void pair_entry(const Args& a, int code,
                                           const Ray& r, float t_test,
                                           Hit& h, int (&ch)[A],
                                           bool (&hit)[A]) {
  if (code > 0) {
    expand_node<A, true, !ANY_HIT, false>(
        a.nodes + (long long)(code - 1) * (7 * A), r, t_test, ch, hit);
    return;
  }
#pragma unroll
  for (int c = 0; c < A; ++c) {
    ch[c] = 0;
    hit[c] = false;
  }
  if (code < 0) {
    ch[0] = leaf_pop<M, 1, true, false>(a, code, r, t_test, h);
    hit[0] = ch[0] != 0;
  }
}

template <bool ANY_HIT, int M, int STACK, int OPT>
__global__ void __launch_bounds__(kBlock) bvh_traverse_option_kernel(Args a) {
  constexpr int A = 8;
  constexpr bool ROW = OPT == kRowLoads;
  constexpr bool NODETEST = OPT != kNoNodeTest;
  constexpr bool SORT = !ANY_HIT && NODETEST && OPT != kNoSort;
  constexpr bool LEAFTEST = OPT != kNoLeafTest;
  constexpr int CHAIN = OPT == kChain2 ? 2 : OPT == kChain4 ? 4 : 1;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a, i);
  const float tmax = a.tmax[i];

  Hit h{tmax, 0.0f, 0.0f, -1, -1};
  int stack[STACK];
  int sp = 0;
  int pops = 0, leaf_pops = 0;
  bool overflow = false;
  // the popped entry: first the root, pushed and popped at once; dead rays
  // never start
  int code = tmax >= r.tmin ? 1 : 0;

  if constexpr (OPT != kPops2) {
    while (code != 0) {
      // node pops while the popped entry is a node: a warp leaves this loop
      // once every ray in it holds a leaf or is done, and runs the leaves
      // together
      while (code > 0) {
        ++pops;
        int ch[A];
        bool hit[A];
        expand_node<A, NODETEST, SORT, ROW>(
            a.nodes + (long long)(code - 1) * (7 * A), r, h.t, ch, hit);
        push<A, STACK, false>(stack, sp, ch, hit);
        code = sp > 0 ? stack[--sp] : 0;
      }
      // leaf pops while the popped entry is a Tri row: the continuation is
      // pushed, and the stack's top popped
      while (code < 0) {
        ++pops;
        ++leaf_pops;
        const int cont = leaf_pop<M, CHAIN, LEAFTEST, ROW>(a, code, r, h.t,
                                                           h);
        if (cont != 0) stack[sp++] = cont;
        if (ANY_HIT && h.prim >= 0) {  // the ray ends: leave both loops
          code = 0;
          break;
        }
        code = sp > 0 ? stack[--sp] : 0;
      }
    }
  } else {
    // the phased body: each trip pops the stack's top two entries (c1 = 0
    // where the stack held one), both tested against t as the trip began
    int c0 = code, c1 = 0;
    while (c0 != 0) {
      // pairs of node rows, in one basic block: their loads fly together
      while (c0 > 0 && c1 > 0) {
        pops += 2;
        int ch0[A], ch1[A];
        bool hit0[A], hit1[A];
        expand_node<A, true, !ANY_HIT, false>(
            a.nodes + (long long)(c0 - 1) * (7 * A), r, h.t, ch0, hit0);
        expand_node<A, true, !ANY_HIT, false>(
            a.nodes + (long long)(c1 - 1) * (7 * A), r, h.t, ch1, hit1);
        // the second entry's children go in first, so the first entry's
        // first child in push order ends on top
        if (!push<A, STACK, true>(stack, sp, ch1, hit1) ||
            !push<A, STACK, true>(stack, sp, ch0, hit0)) {
          overflow = true;
          c0 = 0;
          break;
        }
        c0 = sp > 0 ? stack[--sp] : 0;
        c1 = sp > 0 ? stack[--sp] : 0;
      }
      // pairs with a Tri row, and the last entry alone
      while (c0 != 0 && (c0 < 0 || c1 <= 0)) {
        pops += 1 + (c1 != 0 ? 1 : 0);
        leaf_pops += (c0 < 0 ? 1 : 0) + (c1 < 0 ? 1 : 0);
        // both entries start from the same hit and t
        const float t_test = h.t;
        Hit h0 = h, h1 = h;
        int ch0[A], ch1[A];
        bool hit0[A], hit1[A];
        pair_entry<A, M, ANY_HIT>(a, c0, r, t_test, h0, ch0, hit0);
        pair_entry<A, M, ANY_HIT>(a, c1, r, t_test, h1, ch1, hit1);
        h = h1.t < h0.t ? h1 : h0;  // first-wins on a tie
        if (!push<A, STACK, true>(stack, sp, ch1, hit1) ||
            !push<A, STACK, true>(stack, sp, ch0, hit0)) {
          overflow = true;
          c0 = 0;
          break;
        }
        if (ANY_HIT && h.prim >= 0) {
          c0 = 0;
          break;
        }
        c0 = sp > 0 ? stack[--sp] : 0;
        c1 = sp > 0 ? stack[--sp] : 0;
      }
    }
  }
  a.t[i] = h.t;
  a.u[i] = h.u;
  a.v[i] = h.v;
  a.prim[i] = h.prim;
  a.geom[i] = h.geom;
  a.pops[i] = overflow ? -1 : pops;
  a.leaf_pops[i] = leaf_pops;
}

template <int OPT, bool AH, int M, int S>
int launch_option(const Args& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.n + kBlock - 1) / kBlock);
  bvh_traverse_option_kernel<AH, M, S, OPT><<<grid, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Tri8 or Tri24 rows; stacks of 64 or 128 entries (128 or 256 for
// kPops2, whose bound the wrapper doubles)
template <int OPT, bool AH>
int option_shape(const Args& a, int arity, int m, int cap, cudaStream_t s) {
  constexpr int S = OPT == kPops2 ? 128 : 64;
  if (arity != 8) return (int)cudaErrorInvalidValue;
  if (m == 8 && cap == S) return launch_option<OPT, AH, 8, S>(a, s);
  if (m == 8 && cap == 2 * S) return launch_option<OPT, AH, 8, 2 * S>(a, s);
  if (m == 24 && cap == S) return launch_option<OPT, AH, 24, S>(a, s);
  if (m == 24 && cap == 2 * S)
    return launch_option<OPT, AH, 24, 2 * S>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <bool AH>
int by_option(const Args& a, int option, int arity, int m, int cap,
              cudaStream_t s) {
  switch (option) {
    case kNoNodeTest: return option_shape<kNoNodeTest, AH>(a, arity, m, cap, s);
    case kNoLeafTest: return option_shape<kNoLeafTest, AH>(a, arity, m, cap, s);
    case kNoSort:
      if constexpr (AH) return (int)cudaErrorInvalidValue;
      else return option_shape<kNoSort, AH>(a, arity, m, cap, s);
    case kPops2: return option_shape<kPops2, AH>(a, arity, m, cap, s);
    case kChain2: return option_shape<kChain2, AH>(a, arity, m, cap, s);
    case kChain4: return option_shape<kChain4, AH>(a, arity, m, cap, s);
    case kRowLoads: return option_shape<kRowLoads, AH>(a, arity, m, cap, s);
    case kBase: return option_shape<kBase, AH>(a, arity, m, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // RT_OPTIONS

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

#if defined(RT_GROUP)

// K1 (variant kPlain), K2 (kPrefetch) or K3 (kCount, which writes pops
// and leaf_pops; null for the others) in body kGroup or kStackV1
extern "C" int rt_group_traverse(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int arity, int packet, int any_hit, int stack_cap,
    float* t, float* u, float* v, int* prim, int* geom, int* pops,
    int* leaf_pops, int variant, int body, void* stream) {
  if (n <= 0) return 0;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom,
                           pops, leaf_pops);
  return dispatch(a, body, variant, arity, packet, any_hit, stack_cap,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// Resident 128-thread blocks per SM of one instantiation (body; variant
// kPlain, kPrefetch or kCount; K1's arguments otherwise), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor: launches nothing.
extern "C" int rt_group_traverse_occupancy(int body, int variant, int arity,
                                           int packet, int any_hit,
                                           int stack_cap,
                                           int* blocks_per_sm) {
  const Args a{};
  return dispatch(a, body, variant, arity, packet, any_hit, stack_cap,
                  nullptr, blocks_per_sm);
}

#elif !defined(RT_OPTIONS)

// K1
extern "C" int rt_bvh_traverse(const float* nodes, const float* tris,
                               const float* const* rays, long long n,
                               int arity, int packet, int any_hit,
                               int stack_cap, float* t, float* u, float* v,
                               int* prim, int* geom, void* stream) {
  if (n <= 0) return 0;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom,
                           nullptr, nullptr);
  return dispatch(a, kStackV1, kPlain, arity, packet, any_hit, stack_cap,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// K2: K1's arguments
extern "C" int rt_bvh_traverse_prefetch(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int arity, int packet, int any_hit, int stack_cap,
    float* t, float* u, float* v, int* prim, int* geom, void* stream) {
  if (n <= 0) return 0;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom,
                           nullptr, nullptr);
  return dispatch(a, kStackV1, kPrefetch, arity, packet, any_hit, stack_cap,
                  static_cast<cudaStream_t>(stream), nullptr);
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
  return dispatch(a, kStackV1, kCount, arity, packet, any_hit, stack_cap,
                  static_cast<cudaStream_t>(stream), nullptr);
}

#else

// K4: K3's arguments plus the option (kNoNodeTest ... kBase)
extern "C" int rt_bvh_traverse_option(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int arity, int packet, int any_hit, int stack_cap,
    float* t, float* u, float* v, int* prim, int* geom, int* pops,
    int* leaf_pops, int option, void* stream) {
  if (n <= 0) return 0;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom,
                           pops, leaf_pops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? by_option<true>(a, option, arity, packet, stack_cap, s)
                 : by_option<false>(a, option, arity, packet, stack_cap, s);
}

#endif  // RT_OPTIONS
