// Device code shared by the per-ray kernels (bvh_traverse.cu: K1-K4;
// bvh_ct.cu: K7) and the tile-shared-stack kernels (bvh_tile.cu: K5, K6): a
// ray's inputs, the Batcher network over a node's children and the
// sign-trick Moller-Trumbore of one Tri lane, in the float operation order
// of the plain torch versions (traversal/api.py), the lanes of a wide row
// load (K4, K7) and the exact next-pop L2 prefetch of a Tri row (K2,
// K7-PF). Built with -fmad=false, so every operation is rounded on its
// own, as torch computes it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// one ray's inputs
struct Ray {
  float ix, iy, iz, ox, oy, oz, dx, dy, dz, tmin;
};

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

// Sign-trick Moller-Trumbore of one Tri lane whose fields are f (v0, e1,
// e2, n; xyz each), as _mt_lanes (pallas_packet.py:368-383): returns
// whether the lane passes `t <= t_test`, and its t, u and v either way.
__device__ __forceinline__ bool mt_test(const float (&f)[12], const Ray& r,
                                        float t_test, float& t, float& u,
                                        float& v) {
  const float cx = f[0] - r.ox;
  const float cy = f[1] - r.oy;
  const float cz = f[2] - r.oz;
  const float rx = r.dy * cz - r.dz * cy;
  const float ry = r.dz * cx - r.dx * cz;
  const float rz = r.dx * cy - r.dy * cx;
  const float det = f[9] * r.dx + f[10] * r.dy + f[11] * r.dz;
  const float abs_det = fabsf(det);
  const float sign = det < 0.0f ? -1.0f : 1.0f;
  const float uu = (rx * f[6] + ry * f[7] + rz * f[8]) * sign;
  const float vv = (rx * f[3] + ry * f[4] + rz * f[5]) * sign;
  const float tt = (cx * f[9] + cy * f[10] + cz * f[11]) * sign;
  const bool ok = (uu >= 0.0f) && (vv >= 0.0f) && (uu + vv <= abs_det) &&
                  (abs_det != 0.0f) && (tt >= abs_det * r.tmin) &&
                  (tt <= abs_det * t_test);
  const float inv_det = 1.0f / (abs_det != 0.0f ? abs_det : 1.0f);
  t = tt * inv_det;
  u = uu * inv_det;
  v = vv * inv_det;
  return ok;
}

// mt_test, kept where the lane also beats t_run strictly: then returns true
// with its t, u and v.
__device__ __forceinline__ bool mt_lane(const float (&f)[12], const Ray& r,
                                        float t_test, float t_run, float& t,
                                        float& u, float& v) {
  float tv, uv, vv;
  if (mt_test(f, r, t_test, tv, uv, vv) && tv < t_run) {
    t = tv;
    u = uv;
    v = vv;
    return true;
  }
  return false;
}

// Lane j of a 16-byte row load (K4's and K7's rows are laid out by field,
// so neighbouring lanes of a field are neighbouring floats).
__device__ __forceinline__ float lane_of(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

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

// K2, K7-PF: when stack entry `code` (the exact next pop; 0 = none) is a
// leaf, start bringing its Tri row (a.tris, 14M floats a row) into L2.
template <int M, typename Args>
__device__ __forceinline__ void prefetch_entry(const Args& a, int code) {
  if (code < 0) prefetch_l2(a.tris + (long long)(~code) * (14 * M), 56 * M);
}

}  // namespace
