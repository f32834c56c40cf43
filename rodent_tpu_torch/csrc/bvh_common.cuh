// Device code shared by the per-ray kernels (bvh_traverse.cu: K1-K4) and the
// tile-shared-stack kernels (bvh_tile.cu: K5, K6): a ray's inputs, the
// Batcher network over a node's children and the sign-trick
// Moller-Trumbore of one Tri lane, in the float operation order of the
// plain torch versions (traversal/api.py). Built with -fmad=false, so every
// operation is rounded on its own, as torch computes it.
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

}  // namespace
