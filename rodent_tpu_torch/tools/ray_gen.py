"""ray_gen: generates .rays files (raw 6 x f32 = org, dir per ray); a
copy of rodent_tpu/tools/ray_gen.py.

Mirrors tools/ray_gen/ray_gen.cpp:
- primary: pinhole camera distribution, rows bottom-to-top (ray_gen.cpp
  PrimaryRayGen::generate_rays iterates y from height-1 down), unnormalized
  dir = dir + kx*right*scale + ky*up*scale*h/w;
- shadow: from a point light toward hit points of a previous primary pass
  (requires the .fbuf of hit distances);
- random: rays between random points in the scene bounds (mt19937 based;
  distribution-compatible, not bit-identical).

Usage:
  python -m rodent_tpu_torch.tools.ray_gen primary ex ey ez dx dy dz \
      ux uy uz fov width height out.rays
  python -m rodent_tpu_torch.tools.ray_gen shadow lx ly lz in.rays in.fbuf \
      out.rays
  python -m rodent_tpu_torch.tools.ray_gen random obj_or_bvh count seed \
      out.rays
"""
from __future__ import annotations

import sys

import numpy as np

from ..io import formats, obj


def gen_primary(eye, d, up, fov, width, height):
    eye = np.asarray(eye, np.float32)
    d = np.asarray(d, np.float64)
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float64)
    right = np.cross(d, up)
    right /= np.linalg.norm(right)
    u2 = np.cross(right, d)
    scale = np.tan(np.radians(fov) / 2.0)
    right = right * scale
    u2 = u2 * (float(height) / float(width)) * scale
    sx, sy = 2.0 / width, 2.0 / height
    ys = np.arange(height - 1, -1, -1)
    xs = np.arange(width)
    kx = sx * (xs + 0.5) - 1.0
    ky = sy * (ys + 0.5) - 1.0
    KX, KY = np.meshgrid(kx, ky, indexing="xy")
    dirs = (d[None, None] + KX[..., None] * right[None, None]
            + KY[..., None] * u2[None, None]).reshape(-1, 3)
    orgs = np.tile(eye[None], (len(dirs), 1))
    return orgs.astype(np.float32), dirs.astype(np.float32)


def gen_shadow(light, rays, tvals):
    hitp = rays["org"] + tvals[:, None] * rays["dir"]
    light = np.asarray(light, np.float32)
    orgs = np.tile(light[None], (len(hitp), 1))
    return orgs, (hitp - light).astype(np.float32)


def gen_random(lo, hi, count, seed):
    rng = np.random.RandomState(seed)
    ext = hi - lo
    a = lo + ext * rng.rand(count, 3).astype(np.float32)
    b = lo + ext * rng.rand(count, 3).astype(np.float32)
    return a.astype(np.float32), (b - a).astype(np.float32)


def scene_bounds(path):
    if path.endswith(".obj"):
        mesh, _, _ = obj.load_scene_mesh(path)
        return mesh.vertices.min(0), mesh.vertices.max(0)
    block = formats.read_bvh_all(path)[0]
    b = block.nodes["bounds"][0]  # root node bounds across children
    lo = np.asarray([b[0].min(), b[2].min(), b[4].min()], np.float32)
    hi = np.asarray([b[1].max(), b[3].max(), b[5].max()], np.float32)
    return lo, hi


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    mode = argv[0]
    if mode == "primary":
        (ex, ey, ez, dx, dy, dz, ux, uy, uz, fov, w, h) = argv[1:13]
        out = argv[13]
        orgs, dirs = gen_primary(
            (float(ex), float(ey), float(ez)),
            (float(dx), float(dy), float(dz)),
            (float(ux), float(uy), float(uz)),
            float(fov), int(w), int(h))
    elif mode == "shadow":
        lx, ly, lz, in_rays, in_fbuf, out = argv[1:7]
        rays = formats.read_rays(in_rays)
        t = formats.read_fbuf(in_fbuf)
        orgs, dirs = gen_shadow((float(lx), float(ly), float(lz)), rays, t)
    elif mode == "random":
        scene, count, seed, out = argv[1:5]
        lo, hi = scene_bounds(scene)
        orgs, dirs = gen_random(lo, hi, int(count), int(seed))
    else:
        print(__doc__)
        return 1
    formats.write_rays(out, orgs, dirs)
    print(f"wrote {len(orgs)} rays to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
