"""Sphere, hemisphere and triangle sampling (torch port of
rodent_tpu/core/sampling.py, random.impala:44-131).

Samplers take uniforms drawn by the caller and return local-frame
(z = up) directions plus their pdf, in two forms as in the JAX module:
`*_c` returns the direction as a component tuple of same-shape tensors
(the form the renderer and the lights use), the unsuffixed form stacks it
into a trailing-axis vec3 (core.math.vec3).
"""
from __future__ import annotations

import torch

from .math import luminance, vec3
from .vmath import INV_2PI, INV_4PI, INV_PI, TWO_PI


def dir_from_polar(c, s, phi):
    """make_dir_sample's direction: (s*cos(phi), s*sin(phi), c)."""
    return vec3(s * torch.cos(phi), s * torch.sin(phi), c)


def sample_triangle(u, v, v0, v1, v2):
    """Uniform point on a triangle (random.impala:49-59); v0/v1/v2 (..., 3)
    tensors."""
    flip = (u + v) > 1.0
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    w = 1.0 - v - u
    return w[..., None] * v0 + u[..., None] * v1 + v[..., None] * v2


def sample_triangle_c(u, v, v0, v1, v2):
    """Uniform point on a triangle (random.impala:49-59); v0/v1/v2 Vec3."""
    flip = (u + v) > 1.0
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    w = 1.0 - u - v
    return tuple(w * a + u * b + v * c for a, b, c in zip(v0, v1, v2))


def uniform_sphere_pdf():
    return INV_4PI


def sample_uniform_sphere_c(u, v):
    c = 2.0 * v - 1.0
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    phi = TWO_PI * u
    pdf = torch.full_like(u, uniform_sphere_pdf())
    return (s * torch.cos(phi), s * torch.sin(phi), c), pdf


def sample_uniform_sphere(u, v):
    d, pdf = sample_uniform_sphere_c(u, v)
    return vec3(*d), pdf


def cosine_hemisphere_pdf(c):
    return c * INV_PI


def sample_cosine_hemisphere_c(u, v):
    c = torch.sqrt(torch.clamp(1.0 - v, min=0.0))
    s = torch.sqrt(v)
    phi = TWO_PI * u
    return (s * torch.cos(phi), s * torch.sin(phi), c), \
        cosine_hemisphere_pdf(c)


def sample_cosine_hemisphere(u, v):
    d, pdf = sample_cosine_hemisphere_c(u, v)
    return vec3(*d), pdf


def cosine_power_hemisphere_pdf(c, k):
    return torch.pow(torch.clamp(c, min=0.0), k) * (k + 1.0) * INV_2PI


def sample_cosine_power_hemisphere_c(k, u, v):
    """Cosine-power lobe sample (random.impala:90-101); the pdf uses the
    v/c = cos^k identity so no pow() is evaluated at sample time."""
    c = torch.clamp(torch.pow(v, 1.0 / (k + 1.0)), max=1.0)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    phi = TWO_PI * u
    nz = c != 0.0
    pow_c_k = torch.where(nz, v / torch.where(nz, c, torch.ones_like(c)),
                          torch.zeros_like(c))
    pdf = pow_c_k * (k + 1.0) * INV_2PI
    return (s * torch.cos(phi), s * torch.sin(phi), c), pdf


def sample_cosine_power_hemisphere(k, u, v):
    d, pdf = sample_cosine_power_hemisphere_c(k, u, v)
    return vec3(*d), pdf


def russian_roulette(contrib, clamp=0.75):
    """Continuation probability min(2 * luminance, clamp) of a (..., 3)
    contribution (random.impala:128-131)."""
    return torch.clamp(2.0 * luminance(contrib), max=clamp)
