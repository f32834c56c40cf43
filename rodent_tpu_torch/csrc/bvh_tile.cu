// K5 and K6: BVH traversal for Hopper (sm_90a) with ONE stack shared by a
// tile of rays, in the warp schedule (below), built into the "tile"
// library that the wrappers load (kernels/build.py).
//
// K5 (bvh_traverse_tile) replaces _kernel of
// rodent_tpu/traversal/pallas_packet.py (:395-876, pops=1) with its own
// contract (:1-24), which K1-K4 (bvh_traverse.cu) do not keep: a tile of
// T = 128 * tile_rows consecutive rays walks the union of its rays' node
// sets from one stack. Per pop:
//   node: every ray of the tile slab-tests the 8 children of the row; a
//         child's key is its smallest entry distance over the tile; the
//         hit children are pushed sorted near-first (Batcher network) for
//         closest-hit, in slot order for any-hit. A tile whose rays all
//         share their direction signs on every axis (padding included,
//         :482-491) takes the pure form of the slab test, one near/far
//         select for the tile (:289-303), else the mixed form, a min/max
//         per ray (:305-316); mode kNoPure (ablate "nopure", :794-799)
//         always takes the mixed form. Mode kFrustum (frustum=True,
//         :493-550) tests a pure tile's children against each 128-ray
//         row's interval box instead (node_step_frustum: sign-mirrored
//         origin and |inv_dir| bounds per row, reduced once per tile, and
//         the row's largest t, reduced per pop): a superset of the rays'
//         push set, so the hits stay exact.
//   leaf: every ray runs Moller-Trumbore over the row's M lanes, tested
//         against t as the pop began and kept on a strict < in lane order
//         (_mt_lanes, :352-392); the next row of the leaf is pushed while
//         lane M-1's pid sign bit is clear.
// Any-hit tests a ray that has its hit at t = -FLT_MAX (:706-709), and the
// tile stops when every ray has its hit or is dead (:843-846). Two int32
// counters per tile, always written: pops and leaf pops (:690-699,
// :870-875).
//
// K6 (bvh_traverse_pair) replaces _kernel of experiments/pallas_pair.py
// (:127-425, called from _run :480-557): a tile of tile_rays rays whose
// stack entries are whole nodes, 8 child keys (the tile's smallest entry
// distance, FLT_MAX for a miss or an empty slot), 8 codes and a count of
// children left. A pop takes the nearest child left (the lowest slot on
// ties, :341-363), strips its key and lowers the count, and drops the
// entry at 0. A node (the unordered slab test with the ray's t, no any-hit
// deactivation, :189-215) pushes one entry if any child was hit; a leaf
// folds the 8 lanes per ray, the lower lane keeping a tie (:217-269), and
// pushes its next row as an entry of one child with key 0 (:389-397).
// Any-hit stops the tile when every ray has its hit or is dead (:400-406).
// The TPU kernel's pair tables and matrix-unit broadcast (:55-124,
// :169-184) are its way to spread a row over the 128 lanes; here every
// thread reads the row itself. Ablations (a runtime mask, in the order of
// traversal/pair.py ABLATIONS): nostrip, nosort, nonode, noleaf. Counters
// per tile: pops (:355-356) and, beside them, leaf pops. The iteration
// guard 4 * nodes + 4 * Tri rows + 1024 (:305) marks a tile that reaches
// it.
//
// One block per tile, min(T, 512) threads, thread i owning
// rays i, i + blockDim.x, ... of the tile; u, v and geom go straight to
// the outputs when a ray's hit changes. The stacks are never written past:
// a tile that would overflow (impossible within BvhMeta's worst case,
// which the wrappers pass) or reach K6's guard stops, and its pop counter
// reads -1.
//
// What bounds them on this card: operations. A node pop costs every ray of
// the tile 8 slab tests, whatever share of the rays hits the node, and the
// tile pops the union of its rays' nodes; the pop itself is serial work of
// the whole block (a block-wide minimum costs about 1 us, PERF.md §6, the
// probes).
//
// The first schedule, the TPU's (the rays and the popped row in shared
// memory, thread 0 pops, 3-4 block barriers per node pop), lost to this
// one in every configuration measured and is gone (PERF.md §6). The warp
// schedule is the card's own:
//   - rays in registers: a thread's R = T / blockDim.x rays (1, 2, 4; 8 at
//     tile_rows 32) keep their 13 words in registers (RegRays), up to
//     kRegRaysMax = 4 rays a thread. At 8 (tile_rows 32) ptxas spilled
//     more in registers than with those rays in shared memory (SmemRays,
//     13 words a ray), which spills less. K6's tiles
//     reach 2,048 rays, 4 a thread;
//   - a copy of the stack in every warp (K5: one int an entry; K6: the 17
//     words of an entry, lane l keeping slot l & 7), popped and pushed by
//     the warp itself from values that are the same in every warp, so no
//     warp waits for thread 0; __syncwarp orders a warp's reads and
//     writes. K6's copies take 16 x stack_cap x 68 bytes (64 KB for
//     hall-260K's 59 entries, 139 KB at the largest stack), which fit
//     beside the rays, now out of shared memory; one shared stack with
//     the top entry in each warp's lanes would need a barrier wherever
//     the top is written back, leaf pops included;
//   - each warp reads the popped node or Tri row itself, one child's
//     bounds or one Tri lane's 14 words at a time, every lane on one
//     address, an L1 broadcast: no shared row buffer and no barrier for
//     it. Reading four lanes at once in 16-byte loads held 56 more words
//     in registers and ran slower. A leaf divides by a lane's determinant
//     only where the lane passes (mt_lane_tile, mt_test_pair);
//   - one block barrier per node pop: each warp reduces its per-child
//     minima with 5 exchanges (warp_scatter_min) into red[parity][warp],
//     double-buffered by the parity of the node pop so that the next pop's
//     writes cannot meet this pop's reads; after the barrier every warp
//     folds the warps' minima itself (gather_min) and sorts and pushes its
//     own copy. The frustum publishes each 32 rays' largest t_test in the
//     same buffer and barrier, and every warp runs all rows x 8 interval
//     tests (8 a lane at most) itself;
//   - a closest-hit leaf pop takes no barrier: the next-row push depends on
//     the row alone and each thread updates only its own rays. Any-hit
//     votes once per pop (__syncthreads_and); at a node pop the vote is the
//     reduction's barrier;
//   - a kernel of one ray a thread is built for two resident blocks of 512
//     threads (64 registers); with more rays a thread, one.
//
// At tile_rows 32 the rays' 212,992 bytes in shared memory, beside 16
// copies of the stack (64 bytes an entry) and the frustum mode's 9,344
// static bytes of row boxes, fill the card's 232,448 bytes a block at 158
// entries: the wrapper refuses a frustum tile of 32 rows on a deeper
// stack (traversal/packet.py TILE_FRUSTUM_R32_STACK_MAX).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6,
// chip_smoke.py phase 12: 1M sorted hall-260K primaries, in turns with
// K1): K5 at tile_rows 16 0.9933 ms, 19.9% of its bound, against 1.4450 ms
// and 13.6% for the first schedule (K1 0.3834 ms); at tile_rows 1 0.4318
// against 0.5735 ms; K6 at 2,048 rays 1.1249 against 1.5767 ms. The warp
// schedule was faster in all 38 configurations the phase ran (0.59-0.96x
// the first schedule's time). What is left is the arithmetic of the slab
// tests and the leaf at 16 warps per SM.
//
// The plain torch versions (traversal/api.py traverse_tile_components,
// traversal/pair.py traverse_pair_components) follow the same float
// operations in the same order (a minimum is exact in any order, up to the
// sign of a zero, which reaches no output); built with -fmad=false, the
// kernels agree with them bit for bit in hits and counters.

#include <cuda_runtime.h>
#include <math.h>

#include "bvh_common.cuh"  // Ray, sort_children, mt_test, mt_lane

namespace {

constexpr float kFltMax = 3.402823466e38f;  // a miss's key
constexpr unsigned kFull = 0xffffffffu;
constexpr int kArity = 8;
constexpr int kNodeFloats = 7 * kArity;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxRows = 32;          // 128-ray rows of a K5 tile
constexpr int kMaxStack = 256;        // K5 stack entries
constexpr int kMaxPairStack = 128;    // K6 stack entries (17 words each)
constexpr int kMaxPairTile = 2048;
constexpr int kRayWords = 13;         // words per ray
constexpr int kEntryWords = 2 * kArity + 1;  // a K6 entry: keys, codes, count
constexpr int kRegRaysMax = 4;       // rays a thread holds in registers
// resident blocks per SM a warp-schedule kernel of one ray a thread is
// built for: 64 registers; with more rays a thread, one block (two
// blocks ran one ray a thread faster and made 2,048-ray tiles spill)
constexpr int kMinBlocksR1 = 2;
constexpr int kLeafUnroll = 4;        // Tri lanes a leaf loop unrolls

// K5 modes, in the order of traversal/packet.py TILE_MODES
constexpr int kPlain = 0;
constexpr int kFrustum = 1;
constexpr int kNoPure = 2;

// K6 ablation bits, in the order of traversal/pair.py ABLATIONS; K5's
// nopure mode as a flag (the warp schedule's)
constexpr int kNoStrip = 1;
constexpr int kNoSort = 2;
constexpr int kNoNode = 4;
constexpr int kNoLeaf = 8;
constexpr int kNoPureFlag = 16;

struct Args {
  const float* nodes;  // (N, 56)
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
  int* pops;       // (tiles,) retired entries, -1 for a tile that stopped
  int* leaf_pops;  // (tiles,) leaf entries
  int tile;        // rays per tile
  int stack_cap;   // stack entries the tree needs (<= the static arrays)
  int flags;       // K6: ablation bits; K5: kNoPureFlag
  long long max_iters;  // K6: the iteration guard
};

using KernelFn = void (*)(Args);

// threads of a tile's block
int threads_of(int tile) {
  return tile < kMaxThreads ? tile : kMaxThreads;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}


// Ray words of a thread's rays, in the order of Args' components
enum { kIx, kIy, kIz, kOx, kOy, kOz, kDx, kDy, kDz, kTmin, kTmax, kT };

// A thread's R rays, ray k being ray threadIdx.x + k * blockDim.x of the
// tile: 12 float words and prim each, in registers...
template <int R>
struct RegRays {
  float w[kRayWords - 1][R];
  int p[R];
  __device__ RegRays(float*, int) {}
  __device__ __forceinline__ float& at(int f, int k) { return w[f][k]; }
  __device__ __forceinline__ int& prim(int k) { return p[k]; }
};

// ... or in dynamic shared memory, 13 arrays of `tile` words, where R rays
// would not fit in registers
template <int R>
struct SmemRays {
  float* s;
  int tile;
  __device__ SmemRays(float* smem, int t) : s(smem), tile(t) {}
  __device__ __forceinline__ float& at(int f, int k) {
    return s[f * tile + threadIdx.x + k * blockDim.x];
  }
  __device__ __forceinline__ int& prim(int k) {
    return reinterpret_cast<int*>(s + (kRayWords - 1) * tile)
        [threadIdx.x + k * blockDim.x];
  }
};

template <bool SMEM, int R>
struct RaysPick { using type = RegRays<R>; };
template <int R>
struct RaysPick<true, R> { using type = SmemRays<R>; };
template <int R>
using RaysOf = typename RaysPick<(R > kRegRaysMax), R>::type;

// Loads the thread's rays, padded past n as pack_rays pads (zeros, tmax
// -1), and starts every ray's hit as a miss: t = tmax, prim = -1, and u =
// v = 0 and geom = -1 in the outputs.
template <int R, class RS>
__device__ __forceinline__ void load_rays(const Args& a, RS& rs,
                                          long long base) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long g = base + threadIdx.x + k * blockDim.x;
    const bool in = g < a.n;
    const float* src[kRayWords - 3] = {a.ix, a.iy, a.iz, a.ox, a.oy, a.oz,
                                       a.dx, a.dy, a.dz, a.tmin};
#pragma unroll
    for (int f = 0; f < kRayWords - 3; ++f)
      rs.at(f, k) = in ? src[f][g] : 0.0f;
    rs.at(kTmax, k) = in ? a.tmax[g] : -1.0f;
    rs.at(kT, k) = rs.at(kTmax, k);
    rs.prim(k) = -1;
    if (in) {
      a.u[g] = 0.0f;
      a.v[g] = 0.0f;
      a.geom[g] = -1;
    }
  }
}

template <class RS>
__device__ __forceinline__ Ray ray_at(RS& rs, int k) {
  return Ray{rs.at(kIx, k), rs.at(kIy, k), rs.at(kIz, k),
             rs.at(kOx, k), rs.at(kOy, k), rs.at(kOz, k),
             rs.at(kDx, k), rs.at(kDy, k), rs.at(kDz, k), rs.at(kTmin, k)};
}

// the t a ray tests against; any-hit: -FLT_MAX once it has its hit
template <bool DEACTIVATE, class RS>
__device__ __forceinline__ float t_test_of(RS& rs, int k) {
  return DEACTIVATE && rs.prim(k) >= 0 ? -kFltMax : rs.at(kT, k);
}

// whether every ray of this thread has its hit or is dead (:843-846)
template <int R, class RS>
__device__ __forceinline__ bool rays_done(RS& rs) {
  bool done = true;
#pragma unroll
  for (int k = 0; k < R; ++k)
    done = done && (rs.at(kTmax, k) < rs.at(kTmin, k) || rs.prim(k) >= 0);
  return done;
}

// One child's entry key against one ray from the child's six bounds (x lo,
// x hi, y lo, y hi, z lo, z hi): the float operations of the first
// schedule's slab_key (pallas_packet.py:289-320). FLT_MAX for a miss.
template <bool PURE>
__device__ __forceinline__ float slab_key6(const float (&b)[6], const Ray& r,
                                           float t_test, bool px, bool py,
                                           bool pz) {
  float ent, ext;
  if constexpr (PURE) {
    const float sx = px ? b[0] : b[1], fx = px ? b[1] : b[0];
    const float sy = py ? b[2] : b[3], fy = py ? b[3] : b[2];
    const float sz = pz ? b[4] : b[5], fz = pz ? b[5] : b[4];
    ent = fmaxf(fmaxf((sx - r.ox) * r.ix, (sy - r.oy) * r.iy),
                fmaxf((sz - r.oz) * r.iz, r.tmin));
    ext = fminf(fminf((fx - r.ox) * r.ix, (fy - r.oy) * r.iy),
                fminf((fz - r.oz) * r.iz, t_test));
  } else {
    const float tx0 = (b[0] - r.ox) * r.ix, tx1 = (b[1] - r.ox) * r.ix;
    const float ty0 = (b[2] - r.oy) * r.iy, ty1 = (b[3] - r.oy) * r.iy;
    const float tz0 = (b[4] - r.oz) * r.iz, tz1 = (b[5] - r.oz) * r.iz;
    ent = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                fmaxf(fminf(tz0, tz1), r.tmin));
    ext = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                fminf(fmaxf(tz0, tz1), t_test));
  }
  return ent <= ext ? ent : kFltMax;
}

// The thread's minimum slab key per child over its R rays, reading the
// node row (g) one child's six bounds at a time: every lane of a warp reads
// the same address, an L1 broadcast.
template <int R, bool DEACTIVATE, bool PURE, class RS>
__device__ __forceinline__ void node_keys(RS& rs, const float* g, bool px,
                                          bool py, bool pz,
                                          float (&key)[kArity]) {
#pragma unroll
  for (int c = 0; c < kArity; ++c) {
    float b[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) b[j] = __ldg(g + j * kArity + c);
    key[c] = kFltMax;
#pragma unroll
    for (int k = 0; k < R; ++k)
      key[c] = fminf(key[c], slab_key6<PURE>(b, ray_at(rs, k),
                                             t_test_of<DEACTIVATE>(rs, k),
                                             px, py, pz));
  }
}

// The warp's minimum of each of 8 keys, reduced and scattered at once:
// three exchanges halve the keys a lane holds (xor 16, 8, 4), two more
// finish the minimum (xor 2, 1). Returns in every lane the warp minimum
// of child scatter_child(lane); lanes 0, 4, ..., 28 hold the 8 children
// once each.
__device__ __forceinline__ int scatter_child(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

__device__ __forceinline__ float warp_scatter_min(const float (&key)[kArity],
                                                  int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float k4[4], k2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    k4[i] = fminf(b4 ? key[i + 4] : key[i],
                  __shfl_xor_sync(kFull, b4 ? key[i] : key[i + 4], 16));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    k2[i] = fminf(b3 ? k4[i + 2] : k4[i],
                  __shfl_xor_sync(kFull, b3 ? k4[i] : k4[i + 2], 8));
  float k = fminf(b2 ? k2[1] : k2[0],
                  __shfl_xor_sync(kFull, b2 ? k2[0] : k2[1], 4));
  k = fminf(k, __shfl_xor_sync(kFull, k, 2));
  return fminf(k, __shfl_xor_sync(kFull, k, 1));
}

// After the barrier: the block's minimum key of child lane & 7 from the
// warps' partial minima in buf[warp * 8 + child], in every lane.
__device__ __forceinline__ float gather_min(const float* buf, int nwarps,
                                            int lane) {
  const int c = lane & 7;
  float k = kFltMax;
  for (int w = lane >> 3; w < nwarps; w += 4) k = fminf(k, buf[w * kArity + c]);
  k = fminf(k, __shfl_xor_sync(kFull, k, 8));
  return fminf(k, __shfl_xor_sync(kFull, k, 16));
}

// The block barrier of a node pop; for any-hit it also takes the vote on
// `done` (a node pop changes no hit, so the vote after it is this one).
template <bool VOTE>
__device__ __forceinline__ bool node_barrier(bool done) {
  if constexpr (VOTE) return __syncthreads_and(done);
  __syncthreads();
  return false;
}

// Each 128-ray row's interval box in sign-mirrored coordinates
// (:503-509): each warp reduces its rays per 32-ray chunk into part[chunk],
// then threads r < rows fold the row's four chunks into fr[r] (per axis:
// o2_lo, o2_hi, i2_lo, i2_hi; then tmin_row), from FLT_MAX / -FLT_MAX as
// a fold over the rows starts.
template <int R, class RS>
__device__ void frustum_rows(RS& rs, bool px, bool py, bool pz,
                             float (*part_)[13], float (*fr)[13], int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool pos[3] = {px, py, pz};
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float lo[7], hi[6];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float o = rs.at(kOx + ax, k);
      const float o2 = pos[ax] ? o : -o;
      const float i2 = fabsf(rs.at(kIx + ax, k));
      lo[ax] = o2; hi[ax] = o2;
      lo[3 + ax] = i2; hi[3 + ax] = i2;
    }
    lo[6] = rs.at(kTmin, k);
#pragma unroll
    for (int q = 0; q < 7; ++q) lo[q] = warp_min(lo[q]);
#pragma unroll
    for (int q = 0; q < 6; ++q) hi[q] = warp_max(hi[q]);
    if (lane == 0) {
      float* p = part_[warp + nwarps * k];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        p[4 * ax] = lo[ax];
        p[4 * ax + 1] = hi[ax];
        p[4 * ax + 2] = lo[3 + ax];
        p[4 * ax + 3] = hi[3 + ax];
      }
      p[12] = lo[6];
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < rows * 13; q += blockDim.x) {
    const int r = q / 13, f = q % 13;
    const bool is_max = f < 12 && (f & 1);
    float v = is_max ? -kFltMax : kFltMax;
    for (int c = 0; c < 4; ++c)
      v = is_max ? fmaxf(v, part_[4 * r + c][f])
                 : fminf(v, part_[4 * r + c][f]);
    fr[r][f] = v;
  }
  __syncthreads();
}

// The frustum keys of node_step_frustum (:521-539) after the barrier: lane
// l tests child l & 7 against rows l >> 3, + 4, ... (chunk maxima of the
// rays' t_test in buf) and returns the minimum over its rows.
__device__ __forceinline__ float frustum_key(const float* g, const float* buf,
                                             const float (*fr)[13], int rows,
                                             bool px, bool py, bool pz,
                                             int lane) {
  const int c = lane & 7;
  const bool pos[3] = {px, py, pz};
  float lo[3], hi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    lo[ax] = __ldg(g + 16 * ax + c);
    hi[ax] = __ldg(g + 16 * ax + 8 + c);
  }
  float key = kFltMax;
  for (int r = lane >> 3; r < rows; r += 4) {
    const float t_ub = fmaxf(fmaxf(buf[4 * r], buf[4 * r + 1]),
                             fmaxf(buf[4 * r + 2], buf[4 * r + 3]));
    float ent = 0.0f, ext = 0.0f;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float b_n = pos[ax] ? lo[ax] : -hi[ax];
      const float b_f = pos[ax] ? hi[ax] : -lo[ax];
      const float an = b_n - fr[r][4 * ax + 1];
      const float e_k = an * (an >= 0.0f ? fr[r][4 * ax + 2]
                                         : fr[r][4 * ax + 3]);
      const float bf = b_f - fr[r][4 * ax];
      const float x_k = bf * (bf >= 0.0f ? fr[r][4 * ax + 3]
                                         : fr[r][4 * ax + 2]);
      ent = ax == 0 ? e_k : fmaxf(ent, e_k);
      ext = ax == 0 ? x_k : fminf(ext, x_k);
    }
    ent = fmaxf(ent, fr[r][12]);
    ext = fminf(ext, t_ub);
    key = fminf(key, ent <= ext ? ent : kFltMax);
  }
  return key;
}

// mt_test's arithmetic before its division: whether the lane passes
// `t <= t_test`, with tt, uu, vv and abs_det (bvh_common.cuh), the same
// float operations in the same order.
__device__ __forceinline__ bool mt_pass(const float (&f)[12], const Ray& r,
                                        float t_test, float& tt, float& uu,
                                        float& vv, float& abs_det) {
  const float cx = f[0] - r.ox;
  const float cy = f[1] - r.oy;
  const float cz = f[2] - r.oz;
  const float rx = r.dy * cz - r.dz * cy;
  const float ry = r.dz * cx - r.dx * cz;
  const float rz = r.dx * cy - r.dy * cx;
  const float det = f[9] * r.dx + f[10] * r.dy + f[11] * r.dz;
  abs_det = fabsf(det);
  const float sign = det < 0.0f ? -1.0f : 1.0f;
  uu = (rx * f[6] + ry * f[7] + rz * f[8]) * sign;
  vv = (rx * f[3] + ry * f[4] + rz * f[5]) * sign;
  tt = (cx * f[9] + cy * f[10] + cz * f[11]) * sign;
  return (uu >= 0.0f) && (vv >= 0.0f) && (uu + vv <= abs_det) &&
         (abs_det != 0.0f) && (tt >= abs_det * r.tmin) &&
         (tt <= abs_det * t_test);
}

// mt_lane, dividing only for a lane that passes: the same t, u and v
// where they are kept (a division is some ten instructions, and most lanes
// fail)
__device__ __forceinline__ bool mt_lane_tile(const float (&f)[12],
                                             const Ray& r, float t_test,
                                             float t_run, float& t, float& u,
                                             float& v) {
  float tt, uu, vv, abs_det;
  if (!mt_pass(f, r, t_test, tt, uu, vv, abs_det)) return false;
  const float inv_det = 1.0f / abs_det;   // abs_det != 0 where it passes
  const float tv = tt * inv_det;
  if (!(tv < t_run)) return false;
  t = tv;
  u = uu * inv_det;
  v = vv * inv_det;
  return true;
}

// mt_test for K6's fold: t, u and v of a lane that fails are read only for
// lane 0 (`first`), whose attributes a ray keeps where no lane counts
__device__ __forceinline__ bool mt_test_pair(const float (&f)[12],
                                             const Ray& r, float t_test,
                                             bool first, float& t, float& u,
                                             float& v) {
  float tt, uu, vv, abs_det;
  const bool ok = mt_pass(f, r, t_test, tt, uu, vv, abs_det);
  if (ok || first) {
    const float inv_det = 1.0f / (abs_det != 0.0f ? abs_det : 1.0f);
    t = tt * inv_det;
    u = uu * inv_det;
    v = vv * inv_det;
  }
  return ok;
}

// K5's leaf: every ray of the thread runs Moller-Trumbore over the row's
// M lanes, tested against t as the pop began, the lanes kept on a strict
// < in lane order (_mt_lanes, :352-392); a ray whose hit changed writes u,
// v and geom. The row is read one lane at a time (its 14 words), every ray
// against it: few registers, every lane of a warp on one address.
template <int M, bool ANY_HIT, int R, class RS>
__device__ __forceinline__ void tile_leaf(RS& rs, const float* g,
                                          const Args& a, long long base) {
  const int tid = threadIdx.x;
  float t[R], u[R], v[R], t_test[R];
  int prim[R], geom[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    t[k] = rs.at(kT, k);
    u[k] = v[k] = 0.0f;
    prim[k] = geom[k] = -1;
    t_test[k] = t_test_of<ANY_HIT>(rs, k);
  }
#pragma unroll kLeafUnroll
  for (int l = 0; l < M; ++l) {
    const int pid = __float_as_int(__ldg(g + 12 * M + l));
    if (pid == -1) continue;
    float f[12];
#pragma unroll
    for (int x = 0; x < 12; ++x) f[x] = __ldg(g + x * M + l);
    const int gid = __float_as_int(__ldg(g + 13 * M + l));
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (mt_lane_tile(f, ray_at(rs, k), t_test[k], t[k], t[k], u[k],
                       v[k])) {
        prim[k] = pid & 0x7FFFFFFF;
        geom[k] = gid;
      }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (prim[k] >= 0) {
      rs.at(kT, k) = t[k];
      rs.prim(k) = prim[k];
      const long long gi = base + tid + k * blockDim.x;
      if (gi < a.n) {
        a.u[gi] = u[k];
        a.v[gi] = v[k];
        a.geom[gi] = geom[k];
      }
    }
}

// K6's leaf: every ray of the thread folds the row's 8 lanes (t FLT_MAX
// where a lane fails, the lower lane keeping a tie, :246-261) and takes
// the best on best < t (:262-267). The row is read one lane at a time.
template <int R, class RS>
__device__ __forceinline__ void pair_leaf(RS& rs, const float* g,
                                          const Args& a, long long base) {
  constexpr int M = 8;
  const int tid = threadIdx.x;
  float bt[R], bu[R], bv[R];
  int bp[R], bg[R];
#pragma unroll kLeafUnroll
  for (int l = 0; l < M; ++l) {
    float f[12];
#pragma unroll
    for (int x = 0; x < 12; ++x) f[x] = __ldg(g + x * M + l);
    const int pid = __float_as_int(__ldg(g + 12 * M + l));
    const int gid = __float_as_int(__ldg(g + 13 * M + l));
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float tv, uv, vv;
      const bool ok = mt_test_pair(f, ray_at(rs, k), rs.at(kT, k), l == 0,
                                   tv, uv, vv) && pid != -1;
      tv = ok ? tv : kFltMax;
      if (l == 0 || tv < bt[k]) {
        bt[k] = tv;
        bu[k] = uv;
        bv[k] = vv;
        bp[k] = pid == -1 ? -1 : (pid & 0x7FFFFFFF);
        bg[k] = gid;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (bt[k] < rs.at(kT, k)) {
      rs.at(kT, k) = bt[k];
      rs.prim(k) = bp[k];
      const long long gi = base + tid + k * blockDim.x;
      if (gi < a.n) {
        a.u[gi] = bu[k];
        a.v[gi] = bv[k];
        a.geom[gi] = bg[k];
      }
    }
}

// K5 in the warp schedule. Every warp keeps a copy of the tile's stack in
// shared memory and pops it itself, so every warp walks the same pops;
// ray k of a thread is ray threadIdx.x + k * blockDim.x (R = tile /
// blockDim.x rays a thread).
template <int M, bool ANY_HIT, bool FRUSTUM, int R>
__global__ void __launch_bounds__(kMaxThreads, R == 1 ? kMinBlocksR1 : 1)
    bvh_tile_warp_kernel(Args a) {
  extern __shared__ int wsmem[];
  __shared__ float red[2][kMaxWarps * kArity];  // by the node pop's parity
  __shared__ float fpart[FRUSTUM ? kMaxRows * 4 : 1][13];
  __shared__ float fr[FRUSTUM ? kMaxRows : 1][13];

  const int tile = a.tile;
  const int rows = tile / 128;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int* stack = wsmem + warp * a.stack_cap;
  RaysOf<R> rs(reinterpret_cast<float*>(wsmem + nwarps * a.stack_cap), tile);
  const long long base = (long long)blockIdx.x * tile;
  load_rays<R>(a, rs, base);

  // octant purity of the whole tile, padding included (:487-491)
  bool px = true, nx = true, py = true, ny = true, pz = true, nz = true;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    px = px && rs.at(kIx, k) >= 0.0f; nx = nx && rs.at(kIx, k) < 0.0f;
    py = py && rs.at(kIy, k) >= 0.0f; ny = ny && rs.at(kIy, k) < 0.0f;
    pz = pz && rs.at(kIz, k) >= 0.0f; nz = nz && rs.at(kIz, k) < 0.0f;
  }
  px = __syncthreads_and(px); nx = __syncthreads_and(nx);
  py = __syncthreads_and(py); ny = __syncthreads_and(ny);
  pz = __syncthreads_and(pz); nz = __syncthreads_and(nz);
  const bool pure = (px || nx) && (py || ny) && (pz || nz);
  const bool pure_slab = pure && !(a.flags & kNoPureFlag);
  const bool frustum = FRUSTUM && pure;
  if (frustum) frustum_rows<R>(rs, px, py, pz, fpart, fr, rows);

  int sp = 1, pops = 0, leaf_pops = 0, parity = 0;
  bool overflow = false;
  if (lane == 0) stack[0] = 1;          // root (1-based node ref)
  for (;;) {
    __syncwarp();                       // the last pushes are visible
    if (sp == 0) break;
    const int code = stack[--sp];
    ++pops;
    leaf_pops += code < 0 ? 1 : 0;
    __syncwarp();                       // the top is read before a push
    bool all_done = false;
    if (code > 0) {
      const float* g = a.nodes + (long long)(code - 1) * kNodeFloats;
      float* buf = red[parity];
      parity ^= 1;
      const bool done = ANY_HIT && rays_done<R>(rs);
      int ch[kArity];                   // read before the barrier
#pragma unroll
      for (int c = 0; c < kArity; ++c)
        ch[c] = __float_as_int(__ldg(g + 6 * kArity + c));
      float kc;
      if (frustum) {
        // the largest t_test of each 32 rays, then the row tests
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float m = warp_max(t_test_of<ANY_HIT>(rs, k));
          if (lane == 0) buf[warp + nwarps * k] = m;
        }
        all_done = node_barrier<ANY_HIT>(done);
        kc = frustum_key(g, buf, fr, rows, px, py, pz, lane);
        kc = fminf(kc, __shfl_xor_sync(kFull, kc, 8));
        kc = fminf(kc, __shfl_xor_sync(kFull, kc, 16));
      } else {
        float key[kArity];
        if (pure_slab)
          node_keys<R, ANY_HIT, true>(rs, g, px, py, pz, key);
        else
          node_keys<R, ANY_HIT, false>(rs, g, px, py, pz, key);
        const float mine = warp_scatter_min(key, lane);
        if ((lane & 3) == 0) buf[warp * kArity + scatter_child(lane)] = mine;
        all_done = node_barrier<ANY_HIT>(done);
        kc = gather_min(buf, nwarps, lane);
      }
      // _finalize_children (:324-339) in every lane: invalid children are
      // 0 with key FLT_MAX, then the near-first sort; push the last first
      // so child 0 ends on top (:836-840)
      float key[kArity];
      bool unused[kArity] = {};
      int k = 0;
#pragma unroll
      for (int c = 0; c < kArity; ++c) {
        key[c] = __shfl_sync(kFull, kc, c);
        const bool valid = ch[c] != 0 && key[c] < kFltMax;
        key[c] = valid ? key[c] : kFltMax;
        ch[c] = valid ? ch[c] : 0;
        k += valid ? 1 : 0;
      }
      // one valid child or none: the network moves nothing that is pushed
      if (!ANY_HIT && k > 1) sort_children<kArity>(key, ch, unused);
      if (sp + k > a.stack_cap) {
        overflow = true;
        sp = 0;
      } else {
#pragma unroll
        for (int c = kArity - 1; c >= 0; --c)
          if (ch[c] != 0) {
            if (lane == 0) stack[sp] = ch[c];
            ++sp;
          }
      }
    } else {
      // each thread's rays against the row's M lanes
      const float* g = a.tris + (long long)(~code) * (14 * M);
      tile_leaf<M, ANY_HIT, R>(rs, g, a, base);
      // the next row of the leaf while lane M-1's pid sign bit is clear
      if (__float_as_int(__ldg(g + 13 * M - 1)) >= 0) {
        if (sp + 1 > a.stack_cap) {
          overflow = true;
          sp = 0;
        } else {
          if (lane == 0) stack[sp] = code - 1;
          ++sp;
        }
      }
      // any-hit: the vote of a leaf pop; closest-hit: no barrier
      if (ANY_HIT) all_done = __syncthreads_and(rays_done<R>(rs));
    }
    // any-hit: the tile stops when every ray has its hit or is dead
    if (ANY_HIT && all_done) break;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long g = base + tid + k * blockDim.x;
    if (g < a.n) {
      a.t[g] = rs.at(kT, k);
      a.prim[g] = rs.prim(k);
    }
  }
  if (tid == 0) {
    a.pops[blockIdx.x] = overflow ? -1 : pops;
    a.leaf_pops[blockIdx.x] = leaf_pops;
  }
}

// K6 in the warp schedule. Every warp keeps a copy of the entry stack:
// lane l reads and writes slot l & 7 of an entry (keys and codes), lane 0
// its count.
template <bool ANY_HIT, int R>
__global__ void __launch_bounds__(kMaxThreads, R == 1 ? kMinBlocksR1 : 1)
    bvh_pair_warp_kernel(Args a) {
  constexpr int M = 8;
  extern __shared__ int wsmem[];
  __shared__ float red[2][kMaxWarps * kArity];  // by the node pop's parity

  const int tile = a.tile;
  const int cap = a.stack_cap;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c = lane & 7;
  const bool nostrip = a.flags & kNoStrip, nosort = a.flags & kNoSort;
  const bool nonode = a.flags & kNoNode, noleaf = a.flags & kNoLeaf;
  // this warp's entries: keys (cap x 8), codes (cap x 8), counts (cap)
  int* mine = wsmem + warp * cap * kEntryWords;
  float* ekey = reinterpret_cast<float*>(mine);
  int* ecode = mine + cap * kArity;
  int* ecnt = ecode + cap * kArity;
  RaysOf<R> rs(reinterpret_cast<float*>(wsmem + nwarps * cap * kEntryWords),
               tile);
  const long long base = (long long)blockIdx.x * tile;
  load_rays<R>(a, rs, base);

  int sp = 1, pops = 0, leaf_pops = 0, parity = 0;
  long long iters = 0;
  bool stopped = false;
  // the root entry: one child, code 1, key 0
  if (lane < kArity) {
    ekey[c] = c == 0 ? 0.0f : kFltMax;
    ecode[c] = c == 0 ? 1 : 0;
  }
  if (lane == 0) ecnt[0] = 1;
  for (;;) {
    __syncwarp();                       // the last writes are visible
    bool go = sp > 0;
    if (go && iters >= a.max_iters) {
      stopped = true;
      go = false;
    }
    if (!go) break;
    ++iters;
    const int top = sp - 1;
    const float kc = ekey[top * kArity + c];
    const int cc = ecode[top * kArity + c];
    const int cnt = ecnt[top];
    int slot;
    bool strip = true;
    if (nosort) {
      // the first child with a finite key (slot 7 and no strip if none)
      const unsigned fin = __ballot_sync(kFull, kc < kFltMax) & 0xffu;
      strip = fin != 0;
      slot = strip ? __ffs(fin) - 1 : kArity - 1;
    } else {
      // the nearest; the lowest slot on ties
      float mn = kc;
      mn = fminf(mn, __shfl_xor_sync(kFull, mn, 1));
      mn = fminf(mn, __shfl_xor_sync(kFull, mn, 2));
      mn = fminf(mn, __shfl_xor_sync(kFull, mn, 4));
      const unsigned low = __ballot_sync(kFull, kc <= mn) & 0xffu;
      slot = low ? __ffs(low) - 1 : 0;
    }
    const int code = __shfl_sync(kFull, cc, slot);
    pops += code != 0 ? 1 : 0;
    leaf_pops += code < 0 ? 1 : 0;
    __syncwarp();                       // the entry is read before a write
    if (strip && !nostrip && lane == slot) ekey[top * kArity + slot] = kFltMax;
    const int rem = cnt - 1;
    if (lane == 0) ecnt[top] = rem;
    sp = rem <= 0 ? top : top + 1;
    bool voted = false, all_done = false;
    if (code > 0 && !nonode) {
      // the unordered slab test with the ray's t (:189-215)
      const float* g = a.nodes + (long long)(code - 1) * kNodeFloats;
      float* buf = red[parity];
      parity ^= 1;
      const int ch = __float_as_int(__ldg(g + 6 * kArity + c));
      float key[kArity];
      node_keys<R, false, false>(rs, g, true, true, true, key);
      const float part_min = warp_scatter_min(key, lane);
      if ((lane & 3) == 0)
        buf[warp * kArity + scatter_child(lane)] = part_min;
      all_done = node_barrier<ANY_HIT>(ANY_HIT && rays_done<R>(rs));
      voted = true;
      const float kg = gather_min(buf, nwarps, lane);
      const float kn = ch != 0 ? kg : kFltMax;
      const unsigned hit = __ballot_sync(kFull, kn < kFltMax) & 0xffu;
      if (hit) {
        if (sp >= cap) {
          stopped = true;
          sp = 0;
        } else {
          if (lane < kArity) {
            ekey[sp * kArity + c] = kn;
            ecode[sp * kArity + c] = ch;
          }
          if (lane == 0) ecnt[sp] = __popc(hit);
          ++sp;
        }
      }
    } else if (code < 0 && !noleaf) {
      const float* g = a.tris + (long long)(~code) * (14 * M);
      pair_leaf<R>(rs, g, a, base);
      // the next row of the leaf: one child, key 0, count 1 (:384-397)
      if (__float_as_int(__ldg(g + 12 * M + M - 1)) >= 0) {
        if (sp >= cap) {
          stopped = true;
          sp = 0;
        } else {
          if (lane < kArity) {
            ekey[sp * kArity + c] = c == 0 ? 0.0f : kFltMax;
            ecode[sp * kArity + c] = c == 0 ? code - 1 : 0;
          }
          if (lane == 0) ecnt[sp] = 1;
          ++sp;
        }
      }
    }
    if (ANY_HIT) {
      if (!voted) all_done = __syncthreads_and(rays_done<R>(rs));
      if (all_done) break;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long g = base + tid + k * blockDim.x;
    if (g < a.n) {
      // a miss reads t = tmax and geom -1 (:552-553, :455)
      const bool miss = rs.prim(k) < 0;
      a.t[g] = miss ? rs.at(kTmax, k) : rs.at(kT, k);
      a.prim[g] = rs.prim(k);
      if (miss) a.geom[g] = -1;
    }
  }
  if (tid == 0) {
    a.pops[blockIdx.x] = stopped ? -1 : pops;
    a.leaf_pops[blockIdx.x] = leaf_pops;
  }
}

// The warp schedule's kernels by the rays a thread holds.
template <int M, bool AH, bool FR>
KernelFn k5_rays(int rays) {
  switch (rays) {
    case 1: return bvh_tile_warp_kernel<M, AH, FR, 1>;
    case 2: return bvh_tile_warp_kernel<M, AH, FR, 2>;
    case 4: return bvh_tile_warp_kernel<M, AH, FR, 4>;
    case 8: return bvh_tile_warp_kernel<M, AH, FR, 8>;
    default: return nullptr;
  }
}

KernelFn k5_kernel(int m, bool any_hit, int mode, int tile) {
  if (mode < kPlain || mode > kNoPure) return nullptr;
  const int rays = tile / threads_of(tile);
  const bool fr = mode == kFrustum;
#define RT_K5_FR(M_, AH_) \
  (fr ? k5_rays<M_, AH_, true>(rays) : k5_rays<M_, AH_, false>(rays))
  if (m == 8) return any_hit ? RT_K5_FR(8, true) : RT_K5_FR(8, false);
  if (m == 24) return any_hit ? RT_K5_FR(24, true) : RT_K5_FR(24, false);
#undef RT_K5_FR
  return nullptr;
}

// shared memory a tile's rays take where they are not in registers
size_t smem_rays(int tile) {
  return tile / threads_of(tile) > kRegRaysMax
             ? (size_t)kRayWords * tile * sizeof(float) : 0;
}

size_t k5_smem(int tile, int stack_cap) {
  return (size_t)(threads_of(tile) / 32) * stack_cap * sizeof(int)
         + smem_rays(tile);
}

KernelFn k6_kernel(bool any_hit, int tile) {
  switch (tile / threads_of(tile)) {
    case 1: return any_hit ? bvh_pair_warp_kernel<true, 1>
                           : bvh_pair_warp_kernel<false, 1>;
    case 2: return any_hit ? bvh_pair_warp_kernel<true, 2>
                           : bvh_pair_warp_kernel<false, 2>;
    case 4: return any_hit ? bvh_pair_warp_kernel<true, 4>
                           : bvh_pair_warp_kernel<false, 4>;
    default: return nullptr;
  }
}

size_t k6_smem(int tile, int stack_cap) {
  return (size_t)(threads_of(tile) / 32) * stack_cap * kEntryWords
             * sizeof(int) + smem_rays(tile);
}


// Launches kernel k with one block per tile, threads_of(tile) threads and
// `smem` bytes of dynamic shared memory (above 48 KB only once the kernel
// is allowed that much).
int launch(KernelFn k, const Args& a, size_t smem, cudaStream_t stream) {
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles = (a.n + a.tile - 1) / a.tile;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Args copy = a;
  void* args[] = {&copy};
  const cudaError_t e = cudaLaunchKernel(
      reinterpret_cast<const void*>(k), dim3((unsigned)tiles),
      dim3(threads_of(a.tile)), args, smem, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

Args make_args(const float* nodes, const float* tris,
               const float* const* rays, long long n, float* t, float* u,
               float* v, int* prim, int* geom, int* pops, int* leaf_pops,
               int tile, int stack_cap, int flags, long long max_iters) {
  return Args{nodes, tris,
              rays[0], rays[1], rays[2], rays[3], rays[4], rays[5],
              rays[6], rays[7], rays[8], rays[9], rays[10],
              n, t, u, v, prim, geom, pops, leaf_pops,
              tile, stack_cap, flags, max_iters};
}

bool k5_args_ok(int tile_rows, int stack_cap) {
  return tile_rows >= 1 && tile_rows <= kMaxRows
         && !(tile_rows & (tile_rows - 1)) && stack_cap >= 1
         && stack_cap <= kMaxStack;
}

bool k6_args_ok(int tile_rays, int stack_cap) {
  return tile_rays >= 128 && tile_rays <= kMaxPairTile
         && !(tile_rays & (tile_rays - 1)) && stack_cap >= 1
         && stack_cap <= kMaxPairStack;
}

}  // namespace

// Plain C entries for ctypes. rays points to 11 device pointers (inv_dir
// xyz, org xyz, dir xyz, tmin, tmax), each to n floats; pops and leaf_pops
// to one int32 per tile. Each launches on `stream`, never synchronizes or
// allocates, and returns cudaGetLastError() after the launch (0 = success;
// cudaErrorInvalidValue for a shape it is not built for).

// K5: BVH8 with Tri8 or Tri24 rows; tile_rows 1-32; mode kPlain, kFrustum
// or kNoPure.
extern "C" int rt_bvh_traverse_tile(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int packet, int any_hit, int tile_rows, int mode,
    int stack_cap, float* t, float* u, float* v, int* prim, int* geom,
    int* pops, int* leaf_pops, void* stream) {
  if (n <= 0) return 0;
  if (!k5_args_ok(tile_rows, stack_cap)) return (int)cudaErrorInvalidValue;
  const int tile = 128 * tile_rows;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom, pops,
                           leaf_pops, tile, stack_cap,
                           mode == kNoPure ? kNoPureFlag : 0, 0);
  return launch(k5_kernel(packet, any_hit, mode, tile), a,
                k5_smem(tile, stack_cap), static_cast<cudaStream_t>(stream));
}

// K6: BVH8 with Tri8 rows; tile_rays 128-2048, a power of two; ablate: the
// bits kNoStrip ... kNoLeaf; max_iters: the iteration guard.
extern "C" int rt_bvh_traverse_pair(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int tile_rays, int any_hit, int stack_cap, int ablate,
    long long max_iters, float* t, float* u, float* v, int* prim, int* geom,
    int* pops, int* leaf_pops, void* stream) {
  if (n <= 0) return 0;
  if (!k6_args_ok(tile_rays, stack_cap) || (ablate & ~15))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom, pops,
                           leaf_pops, tile_rays, stack_cap, ablate,
                           max_iters);
  return launch(k6_kernel(any_hit, tile_rays), a,
                k6_smem(tile_rays, stack_cap),
                static_cast<cudaStream_t>(stream));
}

// What one instance of this library holds, for the A/B's table:
// kernel 0 is K5 (packet 8 or 24, mode, tile = 128 * tile_rows), 1 is K6
// (tile_rays; packet and mode not read). out: registers per thread, static
// and dynamic shared memory bytes per block, local memory bytes per thread,
// resident blocks per SM, threads per block.
extern "C" int rt_bvh_tile_resources(int kernel, int packet, int any_hit,
                                     int mode, int tile, int stack_cap,
                                     int* out) {
  const bool k5 = kernel == 0;
  if (k5 ? tile % 128 || !k5_args_ok(tile / 128, stack_cap)
         : kernel != 1 || !k6_args_ok(tile, stack_cap))
    return (int)cudaErrorInvalidValue;
  const KernelFn k = k5 ? k5_kernel(packet, any_hit, mode, tile)
                        : k6_kernel(any_hit, tile);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = k5 ? k5_smem(tile, stack_cap) : k6_smem(tile, stack_cap);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, k, threads_of(tile), smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = (int)fa.localSizeBytes;
  out[4] = blocks;
  out[5] = threads_of(tile);
  return 0;
}
