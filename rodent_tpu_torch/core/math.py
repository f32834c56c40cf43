"""Scalar float helpers and trailing-axis-3 vector math (torch port of
rodent_tpu/core/math.py; vector.impala, matrix.impala, common.impala).

The JAX module's functions under its names, on (..., 3) float32 tensors.
Where the port already has the function in component form
(core/vmath.py: cross, onb, basis_mul), the (..., 3) form here unbinds
the last axis, calls it and stacks the result, so both forms do the same
float operations in the same order.
"""
from __future__ import annotations

import torch

from . import vmath

FLT_MAX = 3.402823466e38
_SIGN_BIT = -2147483648


def vec3(x, y, z, device=None):
    """Stacks three broadcastable components into a (..., 3) f32 tensor."""
    parts = [torch.as_tensor(c, dtype=torch.float32, device=device)
             for c in (x, y, z)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.stack(vmath.cross(a.unbind(-1), b.unbind(-1)), dim=-1)


def length2(a):
    return dot(a, a)


def length(a):
    return torch.sqrt(length2(a))


def normalize(a):
    return a * (1.0 / torch.sqrt(dot(a, a)))[..., None]


def reflect(v, n):
    """Reflects -v about n: 2*dot(n,v)*n - v (vector.impala vec3_reflect)."""
    return 2.0 * dot(n, v)[..., None] * n - v


def lerp(a, b, k):
    """(1 - k) * a + k * b, the JAX module's form (core/vmath.py's lerp is
    a + (b - a) * k, another rounding)."""
    return (1.0 - k) * a + k * b


def lerp2(a, b, c, u, v):
    """Barycentric interpolation (vector.impala vec3_lerp2): u and v either
    broadcast against a, or carry one axis less (per point weights)."""
    w = 1.0 - u - v
    if isinstance(u, torch.Tensor) and u.dim() == a.dim() - 1:
        return w[..., None] * a + u[..., None] * b + v[..., None] * c
    return w * a + u * b + v * c


def prodsign(x, y):
    """x with y's sign bit xor-ed in (common.impala:78-80)."""
    xi = x.to(torch.float32).view(torch.int32)
    yi = y.to(torch.float32).view(torch.int32)
    return (xi ^ (yi & _SIGN_BIT)).view(torch.float32)


def safe_rcp(x):
    """|x| < 1e-8 -> copysign(FLT_MAX, x); else 1/x (common.impala:82-85).
    Keeps the slab test finite for axis-parallel rays."""
    x = x.to(torch.float32)
    big = prodsign(torch.full_like(x, FLT_MAX), x)
    return torch.where(torch.abs(x) < 1e-8, big, 1.0 / x)


def make_orthonormal_basis(n):
    """Branchless orthonormal basis of a unit normal (matrix.impala:29-39):
    (tangent, bitangent, n), each (..., 3)."""
    t, b, _ = vmath.onb(n.unbind(-1))
    return torch.stack(t, dim=-1), torch.stack(b, dim=-1), n


def basis_mul(t, b, n, v):
    """Local-space v to world space: t*v.x + b*v.y + n*v.z."""
    return torch.stack(vmath.basis_mul(t.unbind(-1), b.unbind(-1),
                                       n.unbind(-1), v.unbind(-1)), dim=-1)


def luminance(c):
    """Rec. 709 luminance of a (..., 3) tensor (color.impala:33-35)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722
