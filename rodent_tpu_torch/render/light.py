"""Point and triangle lights (torch port of rodent_tpu/render/light.py;
light.impala, converter.cpp:771-856).

build_light_table is host numpy; pick_uniform, sample_direct,
sample_emission and emission run on torch tensors. kind: 0 = point, 1 =
triangle (area). Textured lights carry uv0/uv1/uv2/ke_tex columns;
sample_direct and emission then return the texture id (and the sampled
point's uv) for the integrator's bank lookup. sample_emission serves light
tracing and photon emission; no renderer of either package calls it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import sampling
from ..core import vmath as vm
from ..core.rng import randf, randi

POINT, TRIANGLE = 0, 1


def build_light_table(mesh, materials_ke, light_tri_mask, ke_tex=None):
    """Triangle lights from emissive triangles with precomputed normal and
    inverse area (converter.cpp:771-856). Returns (table of numpy arrays,
    light_ids per triangle — 0 for non-lights, as the reference leaves
    them). Degenerate emissive triangles are skipped (zero power, never
    hit). Without lights the table holds one black point light
    (converter.cpp:848-850).

    ke_tex: optional per-material emission-texture ids (-1 = constant).
    When a light is textured, the table carries the light triangle's
    vertex uvs and its texture id (columns uv0, uv1, uv2, ke_tex): its
    radiance is the Ke texture at the surface point (the converter's
    has_map_ke branch, converter.cpp:794-806)."""
    tri_idx = mesh.tri_indices
    light_ids = np.zeros(len(tri_idx), np.int32)
    v0s, v1s, v2s, ns, inv_areas, colors = [], [], [], [], [], []
    uv0s, uv1s, uv2s, ktexs = [], [], [], []
    for t in np.nonzero(light_tri_mask)[0]:
        i0, i1, i2 = tri_idx[t]
        v0 = mesh.vertices[i0]
        v1 = mesh.vertices[i1]
        v2 = mesh.vertices[i2]
        n = np.cross(v1 - v0, v2 - v0)
        ln = np.linalg.norm(n)
        if ln <= 0.0 or not np.isfinite(ln):
            continue
        light_ids[t] = len(v0s)
        v0s.append(v0)
        v1s.append(v1)
        v2s.append(v2)
        ns.append(n / ln)
        inv_areas.append(1.0 / (0.5 * ln))
        colors.append(materials_ke[mesh.tri_materials[t]])
        if ke_tex is not None:
            uv0s.append(mesh.texcoords[i0])
            uv1s.append(mesh.texcoords[i1])
            uv2s.append(mesh.texcoords[i2])
            ktexs.append(ke_tex[mesh.tri_materials[t]])
    if not v0s:
        return {
            "kind": np.zeros(1, np.int32),
            "v0": np.zeros((1, 3), np.float32),
            "v1": np.zeros((1, 3), np.float32),
            "v2": np.zeros((1, 3), np.float32),
            "n": np.asarray([[0, 0, 1]], np.float32),
            "inv_area": np.ones(1, np.float32),
            "color": np.zeros((1, 3), np.float32),
        }, light_ids
    table = {
        "kind": np.full(len(v0s), TRIANGLE, np.int32),
        "v0": np.asarray(v0s, np.float32),
        "v1": np.asarray(v1s, np.float32),
        "v2": np.asarray(v2s, np.float32),
        "n": np.asarray(ns, np.float32),
        "inv_area": np.asarray(inv_areas, np.float32),
        "color": np.asarray(colors, np.float32),
    }
    if ke_tex is not None and any(k >= 0 for k in ktexs):
        table["uv0"] = np.asarray(uv0s, np.float32)
        table["uv1"] = np.asarray(uv1s, np.float32)
        table["uv2"] = np.asarray(uv2s, np.float32)
        table["ke_tex"] = np.asarray(ktexs, np.int32)
    return table, light_ids


def pick_uniform(lights_n, rnd):
    """Uniform light pick of on_shadow (renderer.impala:83-85):
    (randi & 0x7FFFFFFF) % num_lights."""
    v, rnd = randi(rnd)
    return (v & 0x7FFFFFFF) % lights_n, rnd


def _row(table, key, light_idx):
    """Per-ray row of a light table column: a (B,) tensor, or a Vec3 of
    them for (n, 3) columns."""
    col = table[key]
    if col.ndim == 1:
        return col[light_idx]
    return tuple(col[:, i][light_idx] for i in range(col.shape[1]))


def sample_direct(table, light_idx, rnd, from_point):
    """Light.sample_direct for a per-ray chosen light (light.impala:81-120).
    Returns (dict(pos, intensity, pdf_area, pdf_dir, cos, has_area, valid,
    and uv, ke_tex where the table is textured), rnd)."""
    kind = _row(table, "kind", light_idx)
    u, rnd = randf(rnd)
    v, rnd = randf(rnd)
    v0 = _row(table, "v0", light_idx)
    v1 = _row(table, "v1", light_idx)
    v2 = _row(table, "v2", light_idx)
    n = _row(table, "n", light_idx)
    inv_area = _row(table, "inv_area", light_idx)
    color = _row(table, "color", light_idx)

    pos_t = sampling.sample_triangle_c(u, v, v0, v1, v2)
    d = vm.sub(from_point, pos_t)
    cos_t = vm.dot(d, n) / torch.clamp(vm.length(d), min=1e-30)
    pdf_dir_t = cos_t * vm.INV_PI

    is_tri = kind == TRIANGLE
    pos = vm.where(is_tri, pos_t, v0)  # point light position lives in v0
    intensity = vm.where(is_tri, color, vm.scale(color, vm.INV_4PI))
    pdf_area = torch.where(is_tri, inv_area, 1.0)
    pdf_dir = torch.where(is_tri, pdf_dir_t, vm.INV_4PI)
    cos = torch.where(is_tri, cos_t, 1.0)

    # make_direct_sample validity (light.impala:81-101)
    valid = (pdf_area > 0.0) & (pdf_dir > 0.0) & (cos > 0.0)
    zero = vm.splat((0.0, 0.0, 0.0), like=cos)
    out = {
        "pos": pos,
        "intensity": vm.where(valid, intensity, zero),
        "pdf_area": torch.where(valid, pdf_area, 1.0),
        "pdf_dir": torch.where(valid, pdf_dir, 1.0),
        "cos": torch.where(valid, cos, 0.0),
        "has_area": is_tri,
        "valid": valid,
    }
    if "ke_tex" in table:
        # uv at the sampled point, with pos_t's barycentrics: the
        # integrator overlays the intensity with the Ke texture there
        uv0 = _row(table, "uv0", light_idx)
        uv1 = _row(table, "uv1", light_idx)
        uv2 = _row(table, "uv2", light_idx)
        flip = (u + v) > 1.0
        uu = torch.where(flip, 1.0 - u, u)
        vv = torch.where(flip, 1.0 - v, v)
        w = 1.0 - uu - vv
        out["uv"] = tuple(w * a + uu * b + vv * c
                          for a, b, c in zip(uv0, uv1, uv2))
        out["ke_tex"] = _row(table, "ke_tex", light_idx)
    return out, rnd


def sample_emission(table, light_idx, rnd):
    """Light.sample_emission (light.impala:35-44; light.py:202-258): a
    point on the light and an outgoing direction. Point lights draw a
    uniform-sphere direction (light.impala:110-116); triangle lights a
    surface point and a cosine-hemisphere direction about their normal
    (make_area_light:131-134). Four uniforms per ray, whatever its kind.
    Returns (dict(pos, dir, intensity, pdf_area, pdf_dir, cos), rnd)."""
    kind = _row(table, "kind", light_idx)
    u, rnd = randf(rnd)
    v, rnd = randf(rnd)
    u2, rnd = randf(rnd)
    v2, rnd = randf(rnd)

    v0 = _row(table, "v0", light_idx)
    v1 = _row(table, "v1", light_idx)
    v2_ = _row(table, "v2", light_idx)
    n = _row(table, "n", light_idx)
    inv_area = _row(table, "inv_area", light_idx)
    color = _row(table, "color", light_idx)

    # triangle: pos uniform on the triangle, dir cosine-distributed about n
    pos_t = sampling.sample_triangle_c(u, v, v0, v1, v2_)
    local, pdf_cos = sampling.sample_cosine_hemisphere_c(u2, v2)
    t_, b_, n_ = vm.onb(n)
    dir_t = vm.basis_mul(t_, b_, n_, local)
    cos_t = local[2]

    # point: pos = v0 (where the table keeps it), dir uniform on the sphere
    dir_p, pdf_sph = sampling.sample_uniform_sphere_c(u2, v2)

    is_tri = kind == TRIANGLE
    pos = vm.where(is_tri, pos_t, v0)
    dirv = vm.where(is_tri, dir_t, dir_p)
    intensity = vm.where(is_tri, color, vm.scale(color, vm.INV_4PI))
    pdf_area = torch.where(is_tri, inv_area, 1.0)
    pdf_dir = torch.where(is_tri, pdf_cos, pdf_sph)
    cos = torch.where(is_tri, cos_t, 1.0)

    # make_emission_sample validity (light.impala:46-66)
    valid = (pdf_area > 0.0) & (pdf_dir > 0.0) & (cos > 0.0)
    zero = vm.splat((0.0, 0.0, 0.0), like=cos)
    return {
        "pos": pos,
        "dir": dirv,
        "intensity": vm.where(valid, intensity, zero),
        "pdf_area": torch.where(valid, pdf_area, 1.0),
        "pdf_dir": torch.where(valid, pdf_dir, 1.0),
        "cos": torch.where(valid, cos, 1.0),
    }, rnd


def emission(table, light_idx, out_dir):
    """Light.emission for an area light hit by a ray (light.impala:146,
    make_area_light:137): intensity = color, pdf_area = inv_area,
    pdf_dir = cos-hemisphere pdf of dot(n, dir); black when pdf_dir <= 0."""
    n = _row(table, "n", light_idx)
    color = _row(table, "color", light_idx)
    inv_area = _row(table, "inv_area", light_idx)
    is_tri = _row(table, "kind", light_idx) == TRIANGLE
    pdf_dir = vm.dot(n, out_dir) * vm.INV_PI
    valid = (pdf_dir > 0.0) & is_tri
    zero = vm.splat((0.0, 0.0, 0.0), like=pdf_dir)
    out = {
        "intensity": vm.where(valid, color, zero),
        "pdf_area": torch.where(valid, inv_area, 1.0),
        "pdf_dir": torch.where(valid, pdf_dir, 1.0),
        "valid": valid,
    }
    if "ke_tex" in table:
        out["ke_tex"] = _row(table, "ke_tex", light_idx)
    return out
