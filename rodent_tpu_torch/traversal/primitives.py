"""Ray records and the single-ray primitives (torch port of
rodent_tpu/traversal/primitives.py; intersection.impala make_ray,
intersect_ray_tri :164-192, intersect_ray_box :194-208, empty_hit).

The primitives take (B,)-batched (..., 3) tensors that broadcast against
each other, as the JAX functions do: Moller-Trumbore with the sign trick
(every comparison on det-scaled values, one reciprocal at the end) and the
unordered slab test. The traversals (traversal/api.py, the CUDA kernels)
carry their own copies of this arithmetic in component form.
"""
from __future__ import annotations

import torch

from ..core.math import cross, dot, prodsign, safe_rcp


def make_rays(org, dir, tmin, tmax, device=None):
    """(B, 3) origins/directions + (B,) or scalar tmin/tmax -> ray dict with
    the precomputed inv_dir / inv_org of make_ray
    (intersection.impala:92-103). Tensors land on `device`, or stay where
    they are when it is None."""
    org = torch.as_tensor(org, dtype=torch.float32, device=device)
    dir = torch.as_tensor(dir, dtype=torch.float32, device=org.device)
    inv_dir = safe_rcp(dir)
    shape = org.shape[:-1]
    return {
        "org": org,
        "dir": dir,
        "inv_dir": inv_dir,
        "inv_org": -(org * inv_dir),
        "tmin": torch.as_tensor(tmin, dtype=torch.float32,
                                device=org.device).expand(shape).clone(),
        "tmax": torch.as_tensor(tmax, dtype=torch.float32,
                                device=org.device).expand(shape).clone(),
    }


def intersect_ray_tri(org, dir, tmin, tmax, v0, e1, e2, n):
    """Moller-Trumbore of rays against triangles given by a vertex, two
    edges and the (unnormalised) normal, all broadcasting, the last axis 3.
    Returns (hit mask, t, u, v); where the mask is False, t, u and v are
    unspecified."""
    c = v0 - org
    r = cross(dir, c)
    det = dot(n, dir)
    abs_det = torch.abs(det)
    u = prodsign(dot(r, e2), det)
    v = prodsign(dot(r, e1), det)
    t = prodsign(dot(c, n), det)
    mask = (u >= 0.0) & (v >= 0.0) & (u + v <= abs_det)
    mask &= abs_det != 0.0
    mask &= (t >= abs_det * tmin) & (t <= abs_det * tmax)
    inv_det = 1.0 / torch.where(abs_det != 0.0, abs_det,
                                torch.ones_like(abs_det))
    return mask, t * inv_det, u * inv_det, v * inv_det


def intersect_ray_box(inv_dir, inv_org, tmin, tmax, lo, hi):
    """Slab test of rays (inv_dir, inv_org = -org * inv_dir) against boxes
    lo/hi, broadcasting, the last axis 3. Returns (entry, exit): a hit
    where entry <= exit."""
    t0 = inv_dir * lo + inv_org
    t1 = inv_dir * hi + inv_org
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    entry = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]),
                          torch.maximum(tn[..., 2], tmin))
    exit_ = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]),
                          torch.minimum(tf[..., 2], tmax))
    return entry, exit_


def intersect_ray_box_soa(inv_dir, inv_org, tmin, tmax, bounds):
    """Slab test against a wide node's bounds (..., 6, A), rows xmin, xmax,
    ymin, ymax, zmin, zmax, one column per child slot; inv_dir, inv_org
    (..., 3), tmin, tmax (...). Returns (entry, exit), each (..., A)."""
    idx = inv_dir[..., :, None]
    iox = inv_org[..., :, None]
    t_lo = idx * bounds[..., 0::2, :] + iox
    t_hi = idx * bounds[..., 1::2, :] + iox
    tn = torch.minimum(t_lo, t_hi)
    tf = torch.maximum(t_lo, t_hi)
    entry = torch.maximum(torch.maximum(tn[..., 0, :], tn[..., 1, :]),
                          torch.maximum(tn[..., 2, :], tmin[..., None]))
    exit_ = torch.minimum(torch.minimum(tf[..., 0, :], tf[..., 1, :]),
                          torch.minimum(tf[..., 2, :], tmax[..., None]))
    return entry, exit_


def empty_hit(tmax):
    """Hit record of a miss: t = tmax, ids -1 (intersection.impala)."""
    return {
        "t": tmax.to(torch.float32).clone(),
        "u": torch.zeros_like(tmax, dtype=torch.float32),
        "v": torch.zeros_like(tmax, dtype=torch.float32),
        "prim_id": torch.full_like(tmax, -1, dtype=torch.int32),
        "geom_id": torch.full_like(tmax, -1, dtype=torch.int32),
    }
