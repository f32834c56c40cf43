"""Octant + Morton ray reordering (torch port of
rodent_tpu/traversal/sorting.py).

The uint32 arithmetic runs in int64 and the permutation comes from a
stable sort, as jnp.argsort's is; keys equal the JAX package's bit for bit
wherever the two rsqrt agree (ray_sort_keys).
"""
from __future__ import annotations

import torch

# the key's 20 direction bits, the only ones 1/|d| reaches
DIR_BITS = (1 << 20) - 1


def ray_octant(d):
    """Octant code from direction signs (intersection.impala:128-132).
    d: Vec3 tuple of (B,) tensors or a (B, 3) tensor."""
    dx, dy, dz = d if isinstance(d, tuple) else d.unbind(-1)
    return ((dx > 0).to(torch.int64) | ((dy > 0).to(torch.int64) << 1)
            | ((dz > 0).to(torch.int64) << 2))


def _morton10(x):
    """Spreads 10 bits to every 3rd bit (30-bit 3D Morton codes)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_keys(org, d, scene_lo, scene_hi, inv_len=None):
    """Key = 9-bit origin Morton (8^3 grid over the scene box), then the
    octant (3 bits), then a 20-bit direction Morton. Returns int64 tensors
    holding the uint32 keys.

    inv_len: each direction's 1/|d| as a (B,) float32 tensor, or None for
    torch.rsqrt(dx*dx + dy*dy + dz*dz + 1e-30). rsqrt is an approximation
    whose last bits differ between XLA's CPU code (and its host CPU),
    torch's and CUDA's rsqrtf; a different 1/|d| can only move the 20
    direction bits. Given the JAX package's own 1/|d|, the key equals its
    key bit for bit."""
    org = org if isinstance(org, tuple) else tuple(org.unbind(-1))
    dt = d if isinstance(d, tuple) else tuple(d.unbind(-1))
    dev = dt[0].device
    lo = torch.as_tensor(scene_lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(scene_hi, dtype=torch.float32, device=dev)
    q = []
    for i in range(3):
        t = (org[i] - lo[i]) / torch.clamp(hi[i] - lo[i], min=1e-30)
        q.append(torch.clamp(t * 8.0, 0, 7).to(torch.int64))
    org_m = (_morton10(q[0]) | (_morton10(q[1]) << 1)
             | (_morton10(q[2]) << 2)) & 0x1FF
    if inv_len is None:
        inv_len = torch.rsqrt(dt[0] * dt[0] + dt[1] * dt[1]
                              + dt[2] * dt[2] + 1e-30)
    qd = [torch.clamp((dt[i] * inv_len * 0.5 + 0.5) * 128.0, 0, 127)
          .to(torch.int64) for i in range(3)]
    dir_m = (_morton10(qd[0]) | (_morton10(qd[1]) << 1)
             | (_morton10(qd[2]) << 2))
    return (org_m << 23) | (ray_octant(dt) << 20) | (dir_m >> 1)


def sort_rays(rays, scene_lo, scene_hi):
    """(rays permuted into key order, permutation); the permutation is that
    of a stable sort. results[perm] = sorted results, so scatter back with
    out[perm] = sorted_out."""
    keys = ray_sort_keys(rays["org"], rays["dir"], scene_lo, scene_hi)
    perm = torch.sort(keys, stable=True).indices
    return {k: v[perm] for k, v in rays.items()}, perm
