"""Procedural benchmark scenes (copy of rodent_tpu/utils/testscenes.py).

The reference benchmarks on Sponza / Crown / San-Miguel meshes that are
not redistributable and not checked in (SURVEY.md §4: sponza.bvh /
sponza-primary.rays must be regenerated from an OBJ). With zero network
egress we instead generate a deterministic "hall" scene of comparable
structure to Sponza: an enclosed rectangular atrium with columns, arches
and a displaced floor, tessellated to a target triangle count. Primary
rays from a camera inside the hall produce a similar traversal profile
(moderate depth, high coherence) to the sponza-primary workload.
"""
from __future__ import annotations

import numpy as np


def _grid_patch(nx, ny, corner, du, dv, displace=None, mat=0):
    """Tessellated quad patch: corner + u*du + v*dv (+ displacement)."""
    u = np.linspace(0.0, 1.0, nx + 1)
    v = np.linspace(0.0, 1.0, ny + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pts = (np.asarray(corner)[None, None]
           + uu[..., None] * np.asarray(du)[None, None]
           + vv[..., None] * np.asarray(dv)[None, None])
    if displace is not None:
        pts = pts + displace(uu, vv)
    verts = pts.reshape(-1, 3)
    idx = []
    for i in range(nx):
        for j in range(ny):
            a = i * (ny + 1) + j
            b = (i + 1) * (ny + 1) + j
            idx.append((a, b, a + 1, mat))
            idx.append((a + 1, b, b + 1, mat))
    return verts.astype(np.float32), np.asarray(idx, np.int32)


def _cylinder(center, radius, height, segments, rings, mat=1):
    """Open cylinder (column)."""
    ang = np.linspace(0, 2 * np.pi, segments + 1)
    hs = np.linspace(0, height, rings + 1)
    verts = []
    for h in hs:
        for a in ang:
            verts.append((center[0] + radius * np.cos(a), center[1] + h,
                          center[2] + radius * np.sin(a)))
    verts = np.asarray(verts, np.float32)
    idx = []
    n = segments + 1
    for r in range(rings):
        for s in range(segments):
            a = r * n + s
            b = (r + 1) * n + s
            idx.append((a, b, a + 1, mat))
            idx.append((a + 1, b, b + 1, mat))
    return verts, np.asarray(idx, np.int32)


def make_hall(target_tris=260_000, seed=7, rich_mats=False):
    """Sponza-class atrium: walls/floor/ceiling patches with sinusoidal
    relief + a grid of columns. Returns (vertices (V,3) f32,
    indices (T*4,) i32) with ~target_tris triangles.

    rich_mats=True assigns bench-MTL material ids (the reference's bench
    scenes are full-MTL interiors mixing textured/specular/glass/mirror
    shaders, converter.cpp:859-927): columns cycle stone(1) / gold-mix(6)
    with two glass(4) and two mirror(5) columns; pair with
    mat_hall_materials() + compile_mesh(materials=..., tex_images=...)."""
    rng = np.random.RandomState(seed)
    # budget: ~55% surfaces, ~45% columns
    patches = []
    W, H, D = 24.0, 12.0, 10.0  # hall extents

    def relief(amp, fx, fy, axis):
        def f(uu, vv):
            d = amp * np.sin(fx * np.pi * uu) * np.cos(fy * np.pi * vv)
            out = np.zeros(uu.shape + (3,), np.float32)
            out[..., axis] = d
            return out
        return f

    surf_tris = int(target_tris * 0.55)
    per_patch = surf_tris // 6
    n = max(int(np.sqrt(per_patch / 2)), 2)
    specs = [
        # floor, ceiling (displaced in y)
        ((0, 0, 0), (W, 0, 0), (0, 0, D), relief(0.15, 9, 7, 1), 0),
        ((0, H, 0), (W, 0, 0), (0, 0, D), relief(0.1, 5, 6, 1), 0),
        # long walls (displaced in z)
        ((0, 0, 0), (W, 0, 0), (0, H, 0), relief(0.2, 11, 5, 2), 2),
        ((0, 0, D), (W, 0, 0), (0, H, 0), relief(0.2, 8, 6, 2), 2),
        # end walls (displaced in x)
        ((0, 0, 0), (0, 0, D), (0, H, 0), relief(0.2, 6, 6, 0), 3),
        ((W, 0, 0), (0, 0, D), (0, H, 0), relief(0.2, 7, 5, 0), 3),
    ]
    all_v, all_i = [], []
    voff = 0
    for corner, du, dv, disp, mat in specs:
        v, i = _grid_patch(n, n, corner, du, dv, disp, mat)
        i[:, :3] += voff
        voff += len(v)
        all_v.append(v)
        all_i.append(i)

    col_tris = target_tris - sum(len(i) for i in all_i)
    cols_x, cols_z = 8, 3
    n_cols = cols_x * cols_z
    per_col = max(col_tris // n_cols, 16)
    segments = max(int(np.sqrt(per_col / 2)), 4)
    rings = max(per_col // (2 * segments), 2)
    for ix in range(cols_x):
        for iz in range(cols_z):
            cm = 1
            if rich_mats:
                k = ix * cols_z + iz
                cm = {4: 4, 9: 5, 14: 4, 19: 5}.get(
                    k, 6 if k % 5 == 2 else 1)
            cx = W * (ix + 0.5) / cols_x + rng.uniform(-0.3, 0.3)
            cz = D * (iz + 0.5) / cols_z + rng.uniform(-0.3, 0.3)
            v, i = _cylinder((cx, 0.0, cz), 0.45 + rng.uniform(0, 0.15),
                             H * 0.85, segments, rings, mat=cm)
            i[:, :3] += voff
            voff += len(v)
            all_v.append(v)
            all_i.append(i)

    verts = np.concatenate(all_v)
    idx = np.concatenate(all_i)
    return verts, idx.reshape(-1)


def mat_hall_materials():
    """Materials + procedural textures for make_hall(rich_mats=True):
    textured-diffuse floor/walls (checker + plaster banks), a MIX stone
    column, PHONG end walls, GLASS and MIRROR columns, and a gold MIX —
    every BSDF kind the reference's bench interiors exercise
    (converter.cpp:859-927; bench.sh:9-85 scenes are full-MTL).
    Returns (materials list indexed by mat id, tex_images dict)."""
    from ..io.obj import Material

    # checker: 256x256, ~0.7/0.35 gray tones, 16-px tiles (linear space)
    g = (np.indices((256, 256)).sum(0) // 16) % 2
    checker = np.where(g[..., None] == 0,
                       np.float32([0.70, 0.66, 0.58]),
                       np.float32([0.30, 0.29, 0.27])).astype(np.float32)
    # plaster: smooth two-frequency sin field around a warm base tone
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    f = (0.5 * np.sin(2 * np.pi * 3 * xx) * np.cos(2 * np.pi * 2 * yy)
         + 0.5 * np.sin(2 * np.pi * 7 * (xx + yy)))
    plaster = (np.float32([0.62, 0.57, 0.48])[None, None]
               * (1.0 + 0.18 * f[..., None])).astype(np.float32)
    tex_images = {"checker": checker, "plaster": plaster}

    materials = [
        Material(name="floor", kd=(1.0, 1.0, 1.0), map_kd="checker"),
        Material(name="stonecol", kd=(0.55, 0.52, 0.48),
                 ks=(0.25, 0.25, 0.25), ns=32.0),            # MIX
        Material(name="wall", kd=(1.0, 1.0, 1.0), map_kd="plaster"),
        Material(name="endwall", ks=(0.45, 0.44, 0.42), ns=12.0),  # PHONG
        Material(name="glasscol", illum=7, ni=1.52,
                 tf=(0.92, 0.95, 0.93)),                     # GLASS
        Material(name="mirrorcol", illum=5,
                 ks=(0.88, 0.90, 0.92)),                     # MIRROR
        Material(name="goldcol", kd=(0.35, 0.25, 0.08),
                 ks=(0.55, 0.42, 0.18), ns=64.0),            # MIX
    ]
    return materials, tex_images


def hall_primary_rays(width=1024, height=1024):
    """Primary rays from inside the hall looking down its length —
    the sponza-primary analog (tools/ray_gen primary distribution)."""
    eye = np.asarray([2.5, 5.0, 5.0], np.float32)
    dirv = np.asarray([1.0, -0.12, 0.02], np.float32)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    d = dirv / np.linalg.norm(dirv)
    right = np.cross(d, up)
    right /= np.linalg.norm(right)
    u2 = np.cross(right, d)
    scale = np.tan(np.radians(60.0) / 2)
    xs = (np.arange(width) + 0.5) / width * 2 - 1
    ys = 1 - (np.arange(height) + 0.5) / height * 2
    kx, ky = np.meshgrid(xs, ys)
    dirs = (d[None, None] + kx[..., None] * scale * right[None, None]
            + ky[..., None] * (scale * height / width) * u2[None, None])
    dirs = dirs.reshape(-1, 3).astype(np.float32)
    org = np.tile(eye[None], (len(dirs), 1))
    return org, dirs


def hall_secondary_rays(kind, hit_org, hit_n, seed=11, ao_tmax=10.0):
    """Secondary-ray distributions from primary hit points, mirroring the
    reference's benchmark distributions (tools/ray_gen.cpp): "ao" =
    short any-hit rays, "bounces" = diffuse (cosine-hemisphere) bounce
    rays — the incoherent workload.

    hit_org (N, 3), hit_n (N, 3) come from a primary-ray trace. Returns
    (org, dir, tmax)."""
    r = np.random.RandomState(seed)
    n = len(hit_org)
    u1 = r.uniform(size=n).astype(np.float32)
    u2 = r.uniform(size=n).astype(np.float32)
    # cosine-weighted hemisphere around the normal
    phi = 2.0 * np.pi * u1
    st = np.sqrt(u2)
    local = np.stack([np.cos(phi) * st, np.sin(phi) * st,
                      np.sqrt(np.maximum(1.0 - u2, 0.0))], axis=1)
    # ONB per hit
    nz = hit_n / np.maximum(np.linalg.norm(hit_n, axis=1, keepdims=True),
                            1e-20)
    h = np.where(np.abs(nz[:, 0:1]) > 0.9, [[0.0, 1.0, 0.0]],
                 [[1.0, 0.0, 0.0]]).astype(np.float32)
    t = np.cross(h, nz)
    t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-20)
    b = np.cross(nz, t)
    d = (local[:, 0:1] * t + local[:, 1:2] * b + local[:, 2:3] * nz)
    org = (hit_org + 1e-3 * nz).astype(np.float32)
    tmax = np.full(n, ao_tmax if kind == "ao" else 3.402823466e38,
                   np.float32)
    return org, d.astype(np.float32), tmax


def secondary_rays_from_trace(kind, org, dirs, t, prim_id, verts, idx4,
                              seed=11, ao_tmax=10.0):
    """Primary-trace results -> the ao/bounces benchmark fixture.

    Single source for the conventions every bench shares (bench.py,
    tools/bench_ref, experiments/*): misses land on an arbitrary finite
    point (t=1), normals are geometric and flipped front-facing, and
    secondary rays start at tmin=1e-3. Returns (org, dir, tmin, tmax)."""
    t = np.where(prim_id >= 0, t, 1.0).astype(np.float32)
    hp = org + dirs * t[:, None]
    tri = np.maximum(prim_id, 0)
    v0 = verts[idx4[tri, 0]]
    v1 = verts[idx4[tri, 1]]
    v2 = verts[idx4[tri, 2]]
    fnrm = np.cross(v0 - v1, v2 - v0)
    fnrm = np.where((fnrm * dirs).sum(1, keepdims=True) > 0, -fnrm, fnrm)
    o2, d2, tmax2 = hall_secondary_rays(kind, hp, fnrm, seed=seed,
                                        ao_tmax=ao_tmax)
    return o2, d2, np.full(len(o2), 1e-3, np.float32), tmax2


def _param_patch(fn, nu, nv, mat=0, close_u=False):
    """Tessellated parametric surface: fn(uu, vv) -> (..., 3) points."""
    u = np.linspace(0.0, 1.0, nu + 1)
    v = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = fn(uu, vv).reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = (i + 1) * (nv + 1) + j
            idx.append((a, b, a + 1, mat))
            idx.append((a + 1, b, b + 1, mat))
    return verts, np.asarray(idx, np.int32)


def make_crown(target_tris=800_000, seed=13):
    """Crown-analog scene (the reference benchmarks on the Blender crown:
    a compact, geometrically dense object with very high depth complexity
    — overlapping filigree in a small volume). Procedural stand-in: a
    torus band carrying rings of displaced bumpy spikes and gem spheres,
    everything overlapping in a tight shell. Camera orbits close so
    primary rays hit many depth layers."""
    rng = np.random.RandomState(seed)
    all_v, all_i, voff = [], [], 0

    def add(v, i):
        nonlocal voff
        i = i.copy()
        i[:, :3] += voff
        voff += len(v)
        all_v.append(v)
        all_i.append(i)

    R, r = 2.0, 0.35            # band torus
    n_spikes = 24
    n_gems = 48
    # triangle budget split: 30% band, 40% spikes, 30% gems
    band_tris = int(target_tris * 0.3)
    nu = max(int(np.sqrt(band_tris / 4)), 8)

    def torus(uu, vv):
        a = 2 * np.pi * uu
        b = 2 * np.pi * vv
        rr = r * (1.0 + 0.15 * np.sin(8 * a) * np.cos(6 * b))
        x = (R + rr * np.cos(b)) * np.cos(a)
        z = (R + rr * np.cos(b)) * np.sin(a)
        y = rr * np.sin(b)
        return np.stack([x, y, z], axis=-1)

    add(*_param_patch(torus, 2 * nu, nu, mat=0))

    spike_tris = int(target_tris * 0.4) // n_spikes
    ns = max(int(np.sqrt(spike_tris / 2)), 4)
    for k in range(n_spikes):
        a = 2 * np.pi * k / n_spikes
        cx, cz = R * np.cos(a), R * np.sin(a)
        h = 1.2 + rng.uniform(-0.2, 0.3)

        def spike(uu, vv, cx=cx, cz=cz, h=h):
            ang = 2 * np.pi * uu
            rad = 0.22 * (1 - vv) * (1 + 0.2 * np.sin(10 * ang))
            x = cx + rad * np.cos(ang)
            z = cz + rad * np.sin(ang)
            y = r + vv * h
            return np.stack([x, y, z], axis=-1)

        add(*_param_patch(spike, ns, ns, mat=1))

    gem_tris = int(target_tris * 0.3) // n_gems
    ng = max(int(np.sqrt(gem_tris / 2)), 4)
    for k in range(n_gems):
        a = 2 * np.pi * (k + 0.5) / n_gems
        cx, cz = R * np.cos(a), R * np.sin(a)
        cy = rng.uniform(-0.1, 0.5)
        rad = rng.uniform(0.1, 0.22)

        def gem(uu, vv, cx=cx, cy=cy, cz=cz, rad=rad):
            th = np.pi * vv
            ph = 2 * np.pi * uu
            # faceted: quantize the sphere angles
            th = np.round(th * 6) / 6
            ph = np.round(ph * 6) / 6
            x = cx + rad * np.sin(th) * np.cos(ph)
            y = cy + rad * np.cos(th)
            z = cz + rad * np.sin(th) * np.sin(ph)
            return np.stack([x, y, z], axis=-1)

        add(*_param_patch(gem, ng, ng, mat=2))

    verts = np.concatenate(all_v)
    idx = np.concatenate(all_i)
    return verts, idx.reshape(-1)


def crown_primary_rays(width=1024, height=1024):
    """Close orbit camera looking at the crown center."""
    eye = np.asarray([4.2, 1.8, 1.2], np.float32)
    target = np.asarray([0.0, 0.4, 0.0], np.float32)
    return _pinhole(eye, target - eye, width, height, fov=42.0)


def make_powerplant(target_tris=2_000_000, seed=17):
    """Powerplant-analog scene (the reference's largest benchmark mesh:
    12.7M tris of mostly axis-aligned industrial piping over huge
    extents). Procedural stand-in: a 3D lattice of axis-aligned pipes at
    two scales plus large boiler cylinders — sparse occupancy, long
    sightlines, the any-hit-friendly profile of the original."""
    rng = np.random.RandomState(seed)
    all_v, all_i, voff = [], [], 0

    def add(v, i):
        nonlocal voff
        i = i.copy()
        i[:, :3] += voff
        voff += len(v)
        all_v.append(v)
        all_i.append(i)

    W = 200.0
    n_pipes = 220
    pipe_tris = int(target_tris * 0.75) // n_pipes
    seg = max(int(np.sqrt(pipe_tris / 8)), 6)

    def pipe(p0, axis, length, rad, mat):
        def f(uu, vv, p0=p0, axis=axis, length=length, rad=rad):
            ang = 2 * np.pi * uu
            a1 = (axis + 1) % 3
            a2 = (axis + 2) % 3
            out = np.zeros(uu.shape + (3,), np.float32)
            out[..., axis] = p0[axis] + vv * length
            out[..., a1] = p0[a1] + rad * np.cos(ang)
            out[..., a2] = p0[a2] + rad * np.sin(ang)
            return out
        return _param_patch(f, seg, 4 * seg, mat=mat)

    for _ in range(n_pipes):
        axis = rng.randint(3)
        p0 = rng.uniform(0, W, 3)
        p0[axis] = rng.uniform(0, W * 0.3)
        length = rng.uniform(W * 0.3, W * 0.7)
        rad = rng.uniform(0.4, 1.6)
        add(*pipe(p0, axis, length, rad, mat=rng.randint(2)))

    n_boilers = 12
    boiler_tris = int(target_tris * 0.25) // n_boilers
    bs = max(int(np.sqrt(boiler_tris / 8)), 8)
    for _ in range(n_boilers):
        p0 = rng.uniform(W * 0.1, W * 0.9, 3)
        p0[1] = 0.0
        h = rng.uniform(W * 0.2, W * 0.5)
        rad = rng.uniform(6.0, 14.0)

        def boiler(uu, vv, p0=p0, h=h, rad=rad):
            ang = 2 * np.pi * uu
            out = np.zeros(uu.shape + (3,), np.float32)
            out[..., 0] = p0[0] + rad * np.cos(ang)
            out[..., 1] = vv * h
            out[..., 2] = p0[2] + rad * np.sin(ang)
            return out

        add(*_param_patch(boiler, 2 * bs, bs, mat=2))

    verts = np.concatenate(all_v)
    idx = np.concatenate(all_i)
    return verts, idx.reshape(-1)


def powerplant_primary_rays(width=1024, height=1024):
    """Wide establishing shot across the plant."""
    eye = np.asarray([-30.0, 60.0, -30.0], np.float32)
    target = np.asarray([100.0, 20.0, 100.0], np.float32)
    return _pinhole(eye, target - eye, width, height, fov=55.0)


def _pinhole(eye, dirv, width, height, fov=60.0):
    d = (dirv / np.linalg.norm(dirv)).astype(np.float32)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    right = np.cross(d, up)
    right /= np.linalg.norm(right)
    u2 = np.cross(right, d)
    scale = np.tan(np.radians(fov) / 2)
    xs = (np.arange(width) + 0.5) / width * 2 - 1
    ys = 1 - (np.arange(height) + 0.5) / height * 2
    kx, ky = np.meshgrid(xs, ys)
    dirs = (d[None, None] + kx[..., None] * scale * right[None, None]
            + ky[..., None] * (scale * height / width) * u2[None, None])
    dirs = dirs.reshape(-1, 3).astype(np.float32)
    org = np.tile(np.asarray(eye, np.float32)[None], (len(dirs), 1))
    return org, dirs


SCENES = {
    "hall": (make_hall, hall_primary_rays),
    "crown": (make_crown, crown_primary_rays),
    "powerplant": (make_powerplant, powerplant_primary_rays),
}
