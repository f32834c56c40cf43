// K5 and K6: BVH traversal for Hopper (sm_90a) with ONE stack shared by a
// tile of rays, built into the "tile" library (kernels/build.py).
//
// K5 (bvh_traverse_tile_kernel) replaces _kernel of
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
// K6 (bvh_traverse_pair_kernel) replaces _kernel of
// experiments/pallas_pair.py (:127-425, called from _run :480-557): a
// tile of tile_rays rays whose stack entries are whole nodes, 8 child keys
// (the tile's smallest entry distance, FLT_MAX for a miss or an empty
// slot), 8 codes and a count of children left. A pop takes the nearest
// child left (the lowest slot on ties, :341-363), strips its key and
// lowers the count, and drops the entry at 0. A node (the unordered
// slab test with the ray's t, no any-hit deactivation, :189-215) pushes
// one entry if any child was hit; a leaf folds the 8 lanes per ray, the
// lower lane keeping a tie (:217-269), and pushes its next row as an entry
// of one child with key 0 (:389-397). Any-hit stops the tile when every
// ray has its hit or is dead (:400-406). The TPU kernel's pair tables and
// matrix-unit broadcast (:55-124, :169-184) are its way to spread a row
// over the 128 lanes; here every thread reads the row from shared memory.
// Ablations (a runtime mask, in the order of traversal/pair.py ABLATIONS):
// nostrip, nosort, nonode, noleaf. Counters per tile: pops (:355-356) and,
// beside them, leaf pops. The iteration guard 4 * nodes + 4 * Tri rows +
// 1024 (:305) marks a tile that reaches it.
//
// Layout of both: one block per tile, min(T, 512) threads, thread i owning
// rays i, i + blockDim.x, ... of the tile. The rays' inputs, their t and
// prim live in shared memory (13 words a ray: 106 KB for 2,048 rays, 213
// KB for 4,096), u, v and geom go straight to the outputs when a ray's hit
// changes. Thread 0 pops; the popped row is read into shared memory once;
// every thread tests its rays; the per-child minimum is taken with warp
// shuffles, then across warps in shared memory by warp 0, whose lane 0
// sorts and pushes. The stacks live in shared memory and are never written
// past: a tile that would overflow (impossible within BvhMeta's worst case,
// which the wrappers pass) or reach K6's guard stops, and its pop counter
// reads -1.
//
// What bounds them on this card: operations. A node pop costs every ray of
// the tile 8 slab tests, whatever share of the rays hits the node, and the
// tile pops the union of its rays' nodes; the pop itself (one thread, a
// dependent chain of shared-memory reads and 3-4 block barriers) is serial
// work of the whole block. Both grow with the tile: wide tiles amortise the
// pop, narrow ones waste fewer tests on rays that miss. The frustum test
// replaces T * 8 slab tests by tile_rows * 8 interval tests, at the price of
// a looser push set (on the TPU, 44 -> 103 pops per tile). This first
// version keeps the TPU's schedule (one pop at a time per tile) and lets
// the card overlap tiles: up to 16 blocks of 128 rays on an SM.
//
// Measured on an H100 80GB HBM3 at 700 W against K1 in turns (PERF.md,
// chip_smoke.py phase 12, 1M sorted hall-260K primaries): tiles of 128 and
// 256 rays within 0.85-1.29x K1's time, of 2,048 rays 1.55-2.28x. A tile
// pop costs a ray less than K1's own pop, but a 2,048-ray tile pops 40.4
// times per ray-equivalent where a ray alone pops 13.2; on ao and bounce
// rays the union grows to 6.5-58x K1's time, and the frustum's looser rows
// make some tiles pop tens of thousands of times.
//
// The plain torch versions (traversal/api.py traverse_tile_components,
// traversal/pair.py traverse_pair_components) follow the same float
// operations in the same order; built with -fmad=false, the kernels agree
// with them bit for bit in hits and counters.

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
constexpr int kRayWords = 13;         // shared-memory words per ray

// K5 modes, in the order of traversal/packet.py TILE_MODES
constexpr int kPlain = 0;
constexpr int kFrustum = 1;
constexpr int kNoPure = 2;

// K6 ablation bits, in the order of traversal/pair.py ABLATIONS
constexpr int kNoStrip = 1;
constexpr int kNoSort = 2;
constexpr int kNoNode = 4;
constexpr int kNoLeaf = 8;

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
  int flags;       // K6: ablation bits
  long long max_iters;  // K6: the iteration guard
};

// The tile's rays in dynamic shared memory: 13 arrays of `tile` words.
struct TileRays {
  float *ix, *iy, *iz, *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax, *t;
  int* prim;
};

__device__ __forceinline__ TileRays tile_rays(float* smem, int tile) {
  TileRays s;
  float* p[kRayWords - 1];
  for (int k = 0; k < kRayWords - 1; ++k) p[k] = smem + k * tile;
  s.ix = p[0]; s.iy = p[1]; s.iz = p[2];
  s.ox = p[3]; s.oy = p[4]; s.oz = p[5];
  s.dx = p[6]; s.dy = p[7]; s.dz = p[8];
  s.tmin = p[9]; s.tmax = p[10]; s.t = p[11];
  s.prim = reinterpret_cast<int*>(smem + (kRayWords - 1) * tile);
  return s;
}

// Loads the tile's rays, padded past n as pack_rays pads (zeros, tmax -1),
// and starts every ray's hit as a miss: t = tmax, prim = -1 here, u = v = 0
// and geom = -1 in the outputs.
__device__ void load_tile(const Args& a, const TileRays& s, long long base) {
  for (int j = threadIdx.x; j < a.tile; j += blockDim.x) {
    const long long g = base + j;
    const bool in = g < a.n;
    s.ix[j] = in ? a.ix[g] : 0.0f;
    s.iy[j] = in ? a.iy[g] : 0.0f;
    s.iz[j] = in ? a.iz[g] : 0.0f;
    s.ox[j] = in ? a.ox[g] : 0.0f;
    s.oy[j] = in ? a.oy[g] : 0.0f;
    s.oz[j] = in ? a.oz[g] : 0.0f;
    s.dx[j] = in ? a.dx[g] : 0.0f;
    s.dy[j] = in ? a.dy[g] : 0.0f;
    s.dz[j] = in ? a.dz[g] : 0.0f;
    s.tmin[j] = in ? a.tmin[g] : 0.0f;
    s.tmax[j] = in ? a.tmax[g] : -1.0f;
    s.t[j] = s.tmax[j];
    s.prim[j] = -1;
    if (in) {
      a.u[g] = 0.0f;
      a.v[g] = 0.0f;
      a.geom[g] = -1;
    }
  }
}

__device__ __forceinline__ Ray ray_of(const TileRays& s, int j) {
  return Ray{s.ix[j], s.iy[j], s.iz[j], s.ox[j], s.oy[j], s.oz[j],
             s.dx[j], s.dy[j], s.dz[j], s.tmin[j]};
}

// whether every ray of this thread has its hit or is dead (:843-846)
__device__ __forceinline__ bool rays_done(const TileRays& s, int tile) {
  bool done = true;
  for (int j = threadIdx.x; j < tile; j += blockDim.x)
    done = done && (s.tmax[j] < s.tmin[j] || s.prim[j] >= 0);
  return done;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// One child's entry key against one ray: the pure form (px/py/pz: the
// tile's direction signs) or the mixed one, in the unfused (b - o) * inv
// form of _slab_parts (pallas_packet.py:289-320). FLT_MAX for a miss.
template <bool PURE>
__device__ __forceinline__ float slab_key(const float* row, int c,
                                          const Ray& r, float t_test,
                                          bool px, bool py, bool pz) {
  float ent, ext;
  if constexpr (PURE) {
    const float sx = px ? row[0 * kArity + c] : row[1 * kArity + c];
    const float fx = px ? row[1 * kArity + c] : row[0 * kArity + c];
    const float sy = py ? row[2 * kArity + c] : row[3 * kArity + c];
    const float fy = py ? row[3 * kArity + c] : row[2 * kArity + c];
    const float sz = pz ? row[4 * kArity + c] : row[5 * kArity + c];
    const float fz = pz ? row[5 * kArity + c] : row[4 * kArity + c];
    ent = fmaxf(fmaxf((sx - r.ox) * r.ix, (sy - r.oy) * r.iy),
                fmaxf((sz - r.oz) * r.iz, r.tmin));
    ext = fminf(fminf((fx - r.ox) * r.ix, (fy - r.oy) * r.iy),
                fminf((fz - r.oz) * r.iz, t_test));
  } else {
    const float tx0 = (row[0 * kArity + c] - r.ox) * r.ix;
    const float tx1 = (row[1 * kArity + c] - r.ox) * r.ix;
    const float ty0 = (row[2 * kArity + c] - r.oy) * r.iy;
    const float ty1 = (row[3 * kArity + c] - r.oy) * r.iy;
    const float tz0 = (row[4 * kArity + c] - r.oz) * r.iz;
    const float tz1 = (row[5 * kArity + c] - r.oz) * r.iz;
    ent = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                fmaxf(fminf(tz0, tz1), r.tmin));
    ext = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                fminf(fmaxf(tz0, tz1), t_test));
  }
  return ent <= ext ? ent : kFltMax;
}

// The per-child tile minimum of the slab keys: each thread over its rays,
// then warp shuffles; lane 0 of every warp writes red[warp][c]. ANY_HIT
// tests rays that have their hit at -FLT_MAX (TILE: K5's rule).
template <bool PURE, bool DEACTIVATE>
__device__ __forceinline__ void tile_slab_keys(const TileRays& s, int tile,
                                               const float* row, bool px,
                                               bool py, bool pz,
                                               float (*red)[kArity]) {
  float key[kArity];
#pragma unroll
  for (int c = 0; c < kArity; ++c) key[c] = kFltMax;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const Ray r = ray_of(s, j);
    const float t_test =
        DEACTIVATE && s.prim[j] >= 0 ? -kFltMax : s.t[j];
#pragma unroll
    for (int c = 0; c < kArity; ++c)
      key[c] = fminf(key[c], slab_key<PURE>(row, c, r, t_test, px, py, pz));
  }
#pragma unroll
  for (int c = 0; c < kArity; ++c) key[c] = warp_min(key[c]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kArity; ++c) red[threadIdx.x >> 5][c] = key[c];
  }
}

// Warp 0: lane c < 8 takes the minimum of child c over `parts` rows of
// part[.][c]; lane 0 returns all 8 keys.
__device__ __forceinline__ void gather_keys(const float (*part)[kArity],
                                            int parts, float (&key)[kArity]) {
  const int lane = threadIdx.x & 31;
  float k = kFltMax;
  if (lane < kArity)
    for (int w = 0; w < parts; ++w) k = fminf(k, part[w][lane]);
#pragma unroll
  for (int c = 0; c < kArity; ++c) key[c] = __shfl_sync(kFull, k, c);
}

template <int M, bool ANY_HIT, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    bvh_traverse_tile_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ int stack[kMaxStack];
  __shared__ float row[14 * M > kNodeFloats ? 14 * M : kNodeFloats];
  __shared__ float red[kMaxWarps][kArity];
  __shared__ float fr[kMaxRows][13];         // the rows' interval boxes
  __shared__ float chunk[kMaxRows * 4];      // t_test max per 32 rays
  __shared__ float fkey[kMaxRows][kArity];   // frustum keys per row
  __shared__ int s_code;

  const int tile = a.tile;
  const int rows = tile / 128;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const TileRays s = tile_rays(smem, tile);
  const long long base = (long long)blockIdx.x * tile;
  load_tile(a, s, base);

  // octant purity of the whole tile, padding included (:487-491)
  bool px = true, nx = true, py = true, ny = true, pz = true, nz = true;
  for (int j = tid; j < tile; j += blockDim.x) {
    px = px && s.ix[j] >= 0.0f; nx = nx && s.ix[j] < 0.0f;
    py = py && s.iy[j] >= 0.0f; ny = ny && s.iy[j] < 0.0f;
    pz = pz && s.iz[j] >= 0.0f; nz = nz && s.iz[j] < 0.0f;
  }
  px = __syncthreads_and(px); nx = __syncthreads_and(nx);
  py = __syncthreads_and(py); ny = __syncthreads_and(ny);
  pz = __syncthreads_and(pz); nz = __syncthreads_and(nz);
  const bool pure = (px || nx) && (py || ny) && (pz || nz);
  const bool frustum = MODE == kFrustum && pure;

  if (frustum) {
    // each 128-ray row's interval box in sign-mirrored coordinates
    // (:503-509): origin' = +-origin, inv' = |inv_dir|, min and max each
    const bool pos[3] = {px, py, pz};
    for (int r = warp; r < rows; r += nwarps) {
      float lo[7], hi[6];
      for (int k = 0; k < 7; ++k) lo[k] = kFltMax;
      for (int k = 0; k < 6; ++k) hi[k] = -kFltMax;
      for (int q = 0; q < 4; ++q) {
        const int j = r * 128 + q * 32 + lane;
        const float o[3] = {s.ox[j], s.oy[j], s.oz[j]};
        const float i[3] = {s.ix[j], s.iy[j], s.iz[j]};
        for (int k = 0; k < 3; ++k) {
          const float o2 = pos[k] ? o[k] : -o[k];
          const float i2 = fabsf(i[k]);
          lo[k] = fminf(lo[k], o2); hi[k] = fmaxf(hi[k], o2);
          lo[3 + k] = fminf(lo[3 + k], i2); hi[3 + k] = fmaxf(hi[3 + k], i2);
        }
        lo[6] = fminf(lo[6], s.tmin[j]);
      }
      for (int k = 0; k < 7; ++k) lo[k] = warp_min(lo[k]);
      for (int k = 0; k < 6; ++k) hi[k] = warp_max(hi[k]);
      if (lane == 0) {
        // per axis: o2_lo, o2_hi, i2_lo, i2_hi; then tmin_row
        for (int k = 0; k < 3; ++k) {
          fr[r][4 * k] = lo[k];
          fr[r][4 * k + 1] = hi[k];
          fr[r][4 * k + 2] = lo[3 + k];
          fr[r][4 * k + 3] = hi[3 + k];
        }
        fr[r][12] = lo[6];
      }
    }
  }

  int sp = 1, pops = 0, leaf_pops = 0;  // thread 0's
  bool overflow = false;
  if (tid == 0) stack[0] = 1;           // root (1-based node ref)
  for (;;) {
    if (tid == 0) {
      int code = 0;
      if (sp > 0) {
        code = stack[--sp];
        ++pops;
        leaf_pops += code < 0 ? 1 : 0;
      }
      s_code = code;
    }
    __syncthreads();
    const int code = s_code;
    if (code == 0) break;
    if (code > 0) {
      const float* g = a.nodes + (long long)(code - 1) * kNodeFloats;
      if (tid < kNodeFloats) row[tid] = __ldg(g + tid);
      __syncthreads();
      float key[kArity];
      if (frustum) {
        // the largest t_test of each 32 rays, then of each row
        for (int j = tid; j < tile; j += blockDim.x) {
          const float tt = ANY_HIT && s.prim[j] >= 0 ? -kFltMax : s.t[j];
          const float m = warp_max(tt);
          if (lane == 0) chunk[j >> 5] = m;
        }
        __syncthreads();
        // (row, child) interval tests of node_step_frustum (:521-539)
        const bool pos[3] = {px, py, pz};
        for (int q = tid; q < rows * kArity; q += blockDim.x) {
          const int r = q / kArity, c = q % kArity;
          const float t_ub = fmaxf(fmaxf(chunk[4 * r], chunk[4 * r + 1]),
                                   fmaxf(chunk[4 * r + 2], chunk[4 * r + 3]));
          float ent = 0.0f, ext = 0.0f;
          for (int k = 0; k < 3; ++k) {
            const float lo = row[16 * k + c], hi = row[16 * k + 8 + c];
            const float b_n = pos[k] ? lo : -hi;
            const float b_f = pos[k] ? hi : -lo;
            const float an = b_n - fr[r][4 * k + 1];
            const float e_k = an * (an >= 0.0f ? fr[r][4 * k + 2]
                                               : fr[r][4 * k + 3]);
            const float bf = b_f - fr[r][4 * k];
            const float x_k = bf * (bf >= 0.0f ? fr[r][4 * k + 3]
                                               : fr[r][4 * k + 2]);
            ent = k == 0 ? e_k : fmaxf(ent, e_k);
            ext = k == 0 ? x_k : fminf(ext, x_k);
          }
          ent = fmaxf(ent, fr[r][12]);
          ext = fminf(ext, t_ub);
          fkey[r][c] = ent <= ext ? ent : kFltMax;
        }
        __syncthreads();
        if (warp == 0) gather_keys(fkey, rows, key);
      } else {
        if (MODE != kNoPure && pure)
          tile_slab_keys<true, ANY_HIT>(s, tile, row, px, py, pz, red);
        else
          tile_slab_keys<false, ANY_HIT>(s, tile, row, px, py, pz, red);
        __syncthreads();
        if (warp == 0) gather_keys(red, nwarps, key);
      }
      if (tid == 0) {
        // _finalize_children (:324-339): invalid children are 0 with key
        // FLT_MAX, then the near-first sort; push the last first so child
        // 0 ends on top (:836-840)
        int ch[kArity];
        bool unused[kArity] = {};
        int k = 0;
#pragma unroll
        for (int c = 0; c < kArity; ++c) {
          ch[c] = __float_as_int(row[6 * kArity + c]);
          const bool valid = ch[c] != 0 && key[c] < kFltMax;
          key[c] = valid ? key[c] : kFltMax;
          ch[c] = valid ? ch[c] : 0;
          k += valid ? 1 : 0;
        }
        if (!ANY_HIT) sort_children<kArity>(key, ch, unused);
        if (sp + k > a.stack_cap) {
          overflow = true;
          sp = 0;
        } else {
          for (int c = kArity - 1; c >= 0; --c)
            if (ch[c] != 0) stack[sp++] = ch[c];
        }
      }
    } else {
      const float* g = a.tris + (long long)(~code) * (14 * M);
      for (int f = tid; f < 14 * M; f += blockDim.x) row[f] = __ldg(g + f);
      __syncthreads();
      const int* rowi = reinterpret_cast<const int*>(row);
      for (int j = tid; j < tile; j += blockDim.x) {
        const Ray r = ray_of(s, j);
        const float t_test = ANY_HIT && s.prim[j] >= 0 ? -kFltMax : s.t[j];
        float t = s.t[j], u = 0.0f, v = 0.0f;
        int prim = -1, geom = -1;
        for (int l = 0; l < M; ++l) {
          const int pid = rowi[12 * M + l];
          if (pid == -1) continue;
          float f[12];
#pragma unroll
          for (int k = 0; k < 12; ++k) f[k] = row[k * M + l];
          if (mt_lane(f, r, t_test, t, t, u, v)) {
            prim = pid & 0x7FFFFFFF;
            geom = rowi[13 * M + l];
          }
        }
        if (prim >= 0) {
          s.t[j] = t;
          s.prim[j] = prim;
          const long long gi = base + j;
          if (gi < a.n) {
            a.u[gi] = u;
            a.v[gi] = v;
            a.geom[gi] = geom;
          }
        }
      }
      if (tid == 0 && rowi[13 * M - 1] >= 0) {
        if (sp + 1 > a.stack_cap) {
          overflow = true;
          sp = 0;
        } else {
          stack[sp++] = code - 1;
        }
      }
    }
    // any-hit: the tile stops when every ray has its hit or is dead
    if (ANY_HIT && __syncthreads_and(rays_done(s, tile))) break;
  }
  __syncthreads();
  for (int j = tid; j < tile; j += blockDim.x) {
    const long long g = base + j;
    if (g < a.n) {
      a.t[g] = s.t[j];
      a.prim[g] = s.prim[j];
    }
  }
  if (tid == 0) {
    a.pops[blockIdx.x] = overflow ? -1 : pops;
    a.leaf_pops[blockIdx.x] = leaf_pops;
  }
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kMaxThreads)
    bvh_traverse_pair_kernel(Args a) {
  constexpr int M = 8;
  extern __shared__ float smem[];
  __shared__ float ekey[kMaxPairStack][kArity];   // the entries' keys
  __shared__ int ecode[kMaxPairStack][kArity];    // their child codes
  __shared__ int ecnt[kMaxPairStack];             // children left
  __shared__ float row[14 * M];
  __shared__ float red[kMaxWarps][kArity];
  __shared__ int s_code;
  __shared__ int s_go;

  const int tile = a.tile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool nostrip = a.flags & kNoStrip, nosort = a.flags & kNoSort;
  const bool nonode = a.flags & kNoNode, noleaf = a.flags & kNoLeaf;
  const TileRays s = tile_rays(smem, tile);
  const long long base = (long long)blockIdx.x * tile;
  load_tile(a, s, base);

  int sp = 1, pops = 0, leaf_pops = 0;  // thread 0's
  long long iters = 0;
  bool stopped = false;
  if (tid == 0) {
    // the root entry: one child, code 1, key 0
    for (int c = 0; c < kArity; ++c) {
      ekey[0][c] = c == 0 ? 0.0f : kFltMax;
      ecode[0][c] = c == 0 ? 1 : 0;
    }
    ecnt[0] = 1;
  }
  __syncthreads();
  for (;;) {
    if (tid == 0) {
      int code = 0;
      bool go = sp > 0;
      if (go && iters >= a.max_iters) {
        stopped = true;
        go = false;
      }
      if (go) {
        ++iters;
        const int top = sp - 1;
        int slot = 0;
        bool strip = true;
        if (nosort) {
          // the first child with a finite key (slot 7 and no strip if none)
          slot = kArity;
          for (int c = kArity - 1; c >= 0; --c)
            slot = ekey[top][c] < kFltMax ? c : slot;
          strip = slot < kArity;
          slot = strip ? slot : kArity - 1;
        } else {
          // the nearest; the lowest slot on ties
          float mn = ekey[top][0];
          for (int c = 1; c < kArity; ++c) mn = fminf(mn, ekey[top][c]);
          slot = kArity;
          for (int c = kArity - 1; c >= 0; --c)
            slot = ekey[top][c] <= mn ? c : slot;
          slot = slot < kArity ? slot : 0;
        }
        code = ecode[top][slot];
        pops += code != 0 ? 1 : 0;
        leaf_pops += code < 0 ? 1 : 0;
        if (strip && !nostrip) ekey[top][slot] = kFltMax;
        const int rem = ecnt[top] - 1;
        ecnt[top] = rem;
        sp = rem <= 0 ? top : top + 1;
      }
      s_code = code;
      s_go = go;
    }
    __syncthreads();
    if (!s_go) break;
    const int code = s_code;
    if (code > 0 && !nonode) {
      const float* g = a.nodes + (long long)(code - 1) * kNodeFloats;
      if (tid < kNodeFloats) row[tid] = __ldg(g + tid);
      __syncthreads();
      tile_slab_keys<false, false>(s, tile, row, true, true, true, red);
      __syncthreads();
      float key[kArity];
      if (warp == 0) gather_keys(red, nwarps, key);
      if (tid == 0) {
        int k = 0;
        for (int c = 0; c < kArity; ++c) {
          const int ch = __float_as_int(row[6 * kArity + c]);
          key[c] = ch != 0 ? key[c] : kFltMax;
          k += key[c] < kFltMax ? 1 : 0;
        }
        if (k > 0) {
          if (sp >= a.stack_cap) {
            stopped = true;
            sp = 0;
          } else {
            for (int c = 0; c < kArity; ++c) {
              ekey[sp][c] = key[c];
              ecode[sp][c] = __float_as_int(row[6 * kArity + c]);
            }
            ecnt[sp] = k;
            ++sp;
          }
        }
      }
    } else if (code < 0 && !noleaf) {
      const float* g = a.tris + (long long)(~code) * (14 * M);
      for (int f = tid; f < 14 * M; f += blockDim.x) row[f] = __ldg(g + f);
      __syncthreads();
      const int* rowi = reinterpret_cast<const int*>(row);
      for (int j = tid; j < tile; j += blockDim.x) {
        const Ray r = ray_of(s, j);
        const float t_cur = s.t[j];
        // fold the 8 lanes: t FLT_MAX where a lane fails, the lower lane
        // keeps a tie (:246-261); then update on best < t (:262-267)
        float bt = 0.0f, bu = 0.0f, bv = 0.0f;
        int bp = -1, bg = -1;
#pragma unroll
        for (int l = 0; l < M; ++l) {
          float f[12];
#pragma unroll
          for (int k = 0; k < 12; ++k) f[k] = row[k * M + l];
          const int pid = rowi[12 * M + l];
          float tv, uv, vv;
          const bool ok = mt_test(f, r, t_cur, tv, uv, vv) && pid != -1;
          tv = ok ? tv : kFltMax;
          if (l == 0 || tv < bt) {
            bt = tv;
            bu = uv;
            bv = vv;
            bp = pid == -1 ? -1 : (pid & 0x7FFFFFFF);
            bg = rowi[13 * M + l];
          }
        }
        if (bt < t_cur) {
          s.t[j] = bt;
          s.prim[j] = bp;
          const long long gi = base + j;
          if (gi < a.n) {
            a.u[gi] = bu;
            a.v[gi] = bv;
            a.geom[gi] = bg;
          }
        }
      }
      // the next row of the leaf: one child, key 0, count 1 (:384-397)
      if (tid == 0 && rowi[12 * M + M - 1] >= 0) {
        if (sp >= a.stack_cap) {
          stopped = true;
          sp = 0;
        } else {
          for (int c = 0; c < kArity; ++c) {
            ekey[sp][c] = c == 0 ? 0.0f : kFltMax;
            ecode[sp][c] = c == 0 ? code - 1 : 0;
          }
          ecnt[sp] = 1;
          ++sp;
        }
      }
    }
    if (ANY_HIT && __syncthreads_and(rays_done(s, tile))) break;
  }
  __syncthreads();
  for (int j = tid; j < tile; j += blockDim.x) {
    const long long g = base + j;
    if (g < a.n) {
      // a miss reads t = tmax and geom -1 (:552-553, :455)
      const bool miss = s.prim[j] < 0;
      a.t[g] = miss ? s.tmax[j] : s.t[j];
      a.prim[g] = s.prim[j];
      if (miss) a.geom[g] = -1;
    }
  }
  if (tid == 0) {
    a.pops[blockIdx.x] = stopped ? -1 : pops;
    a.leaf_pops[blockIdx.x] = leaf_pops;
  }
}

// Launches `kernel` with one block per tile, min(tile, 512) threads and the
// tile's rays in dynamic shared memory (above 48 KB only once the kernel
// is allowed that much).
template <typename K>
int launch_tiles(K kernel, const Args& a, cudaStream_t stream) {
  const long long tiles = (a.n + a.tile - 1) / a.tile;
  const int threads = a.tile < kMaxThreads ? a.tile : kMaxThreads;
  const size_t bytes = (size_t)kRayWords * a.tile * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)tiles, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int M, bool AH>
int tile_mode(const Args& a, int mode, cudaStream_t s) {
  switch (mode) {
    case kPlain:
      return launch_tiles(bvh_traverse_tile_kernel<M, AH, kPlain>, a, s);
    case kFrustum:
      return launch_tiles(bvh_traverse_tile_kernel<M, AH, kFrustum>, a, s);
    case kNoPure:
      return launch_tiles(bvh_traverse_tile_kernel<M, AH, kNoPure>, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (tile_rows < 1 || tile_rows > kMaxRows || (tile_rows & (tile_rows - 1))
      || stack_cap < 1 || stack_cap > kMaxStack)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom, pops,
                           leaf_pops, 128 * tile_rows, stack_cap, 0, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packet == 8)
    return any_hit ? tile_mode<8, true>(a, mode, s)
                   : tile_mode<8, false>(a, mode, s);
  if (packet == 24)
    return any_hit ? tile_mode<24, true>(a, mode, s)
                   : tile_mode<24, false>(a, mode, s);
  return (int)cudaErrorInvalidValue;
}

// K6: BVH8 with Tri8 rows; tile_rays 128-2048, a power of two; ablate: the
// bits kNoStrip ... kNoLeaf; max_iters: the iteration guard.
extern "C" int rt_bvh_traverse_pair(
    const float* nodes, const float* tris, const float* const* rays,
    long long n, int tile_rays, int any_hit, int stack_cap, int ablate,
    long long max_iters, float* t, float* u, float* v, int* prim, int* geom,
    int* pops, int* leaf_pops, void* stream) {
  if (n <= 0) return 0;
  if (tile_rays < 128 || tile_rays > kMaxPairTile
      || (tile_rays & (tile_rays - 1)) || stack_cap < 1
      || stack_cap > kMaxPairStack || (ablate & ~15))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(nodes, tris, rays, n, t, u, v, prim, geom, pops,
                           leaf_pops, tile_rays, stack_cap, ablate,
                           max_iters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch_tiles(bvh_traverse_pair_kernel<true>, a, s)
                 : launch_tiles(bvh_traverse_pair_kernel<false>, a, s);
}
