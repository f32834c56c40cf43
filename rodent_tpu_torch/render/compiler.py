"""Scene compiler: OBJ/MTL or procedural mesh -> device-ready scene
(torch port of rodent_tpu/render/compiler.py; the converter analog of
converter.cpp:575-967).

compile_obj reads an OBJ with its MTL libraries and texture images
(cleanup_obj's dummy material, dedup and removal of unused materials,
converter.cpp:467-557); compile_mesh dresses a procedural mesh
(palette or caller materials, procedural textures on triplanar uvs, an
emitter panel); load_data_dir reads the converter's data/ directory back.
The host side (material mapping, smooth normals, light table, texture
bank, BVH build) is the JAX package's numpy code, copied because that
module imports jax; only the last step differs: the tables become torch
tensors on an explicit device. `from_jax_device` carries a JAX
CompiledScene.device across instead, so both packages can trace the very
same tables.

The tier rule (packet_mode and the policies built on it) measures the
scene's tables against the card's L2, where the TPU measured them against
VMEM.
"""
from __future__ import annotations

import json
import os
import struct
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..accel import WideBvh, build_bvh
from ..io import formats
from ..io import obj as obj_io
from ..traversal.api import BvhMeta, bvh_to_device
from ..traversal.dense import DENSE_MAX_PACKETS
from . import bsdf as bsdf_mod
from . import light as light_mod
from . import texture as tx


def _luminance(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def material_to_params(mat, tex_index=None):
    """Maps an obj Material to (kind, params) per converter.cpp:859-927.
    tex_index maps texture file names to bank ids (-1 = untextured)."""
    tex_index = tex_index or {}
    ke = tuple(mat.ke)
    emissive = ke != (0.0, 0.0, 0.0) or mat.map_ke != ""
    if mat.illum == 5:
        kind = bsdf_mod.MIRROR
    elif mat.illum == 7:
        kind = bsdf_mod.GLASS
    else:
        has_diffuse = tuple(mat.kd) != (0.0, 0.0, 0.0) or mat.map_kd != ""
        has_specular = tuple(mat.ks) != (0.0, 0.0, 0.0) or mat.map_ks != ""
        if has_diffuse and has_specular:
            kind = bsdf_mod.MIX
        elif has_diffuse:
            kind = bsdf_mod.DIFFUSE
        elif has_specular:
            kind = bsdf_mod.PHONG
        else:
            kind = bsdf_mod.BLACK
    lum_ks = _luminance(mat.ks)
    lum_kd = _luminance(mat.kd)
    mix_k = lum_ks / (lum_ks + lum_kd) if (lum_ks + lum_kd) != 0.0 else 0.0
    return {
        "kind": kind,
        "kd": tuple(mat.kd),
        "ks": tuple(mat.ks),
        "ns": float(mat.ns),
        "ni": float(mat.ni),
        "tf": tuple(mat.tf),
        "mix_k": float(mix_k),
        "emissive": bool(emissive),
        "ke": ke,
        "kd_tex": tex_index.get(mat.map_kd, -1),
        "ks_tex": tex_index.get(mat.map_ks, -1),
    }


def _dummy_material():
    """cleanup_obj's dummy material (converter.cpp:469-485): cyan kd."""
    m = obj_io.Material(name="")
    m.kd = (0.0, 1.0, 1.0)
    return m


def _mat_eq(a, b):
    return (a.ka == b.ka and a.kd == b.kd and a.ks == b.ks and a.ke == b.ke
            and a.ns == b.ns and a.ni == b.ni and a.tf == b.tf
            and a.illum == b.illum and a.map_kd == b.map_kd
            and a.map_ks == b.map_ks and a.map_ke == b.map_ke)


@dataclass
class CompiledScene:
    device: dict                      # tensors for the integrator
    mesh: object                      # host TriMesh
    materials: list                   # material names after cleanup
    mat_params: list = field(default_factory=list)
    num_lights: int = 0
    tex_files: list = field(default_factory=list)


def _to(x, device, dtype=None):
    """A copy of array x as a tensor on `device`."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _build_device(mesh, mat_params, lights, light_ids, bvh, max_path_len,
                  num_lights, device, tex_images=None):
    """Assembles the integrator-facing device dict (compiler.py:96-183):
    material table, packed geometry rows, the pre-joined per-triangle
    shading row, lights, the BVH tables and the texture bank of
    `tex_images` (linear (H, W, 3) images in bank-id order), as tensors
    on `device`. compile_obj, compile_mesh and load_data_dir all end
    here, so their tables agree bit for bit."""
    def col(key, dtype):
        return torch.as_tensor([p[key] for p in mat_params], dtype=dtype,
                               device=device)

    mat_table = {
        "kind": col("kind", torch.int32),
        "kd": col("kd", torch.float32),
        "ks": col("ks", torch.float32),
        "ns": col("ns", torch.float32),
        "ni": col("ni", torch.float32),
        "tf": col("tf", torch.float32),
        "mix_k": col("mix_k", torch.float32),
        "emissive": col("emissive", torch.bool),
        "kd_tex": col("kd_tex", torch.int32),
        "ks_tex": col("ks_tex", torch.int32),
    }

    # tri row: [i0, i1, i2, mat (i32 bits), fn.xyz, light_id (i32 bits)]
    idx4 = mesh.indices.reshape(-1, 4)
    tri_geo = np.zeros((len(idx4), 8), np.float32)
    tri_geo[:, 0:4] = idx4.astype(np.int32).view(np.float32)
    tri_geo[:, 4:7] = mesh.face_normals
    tri_geo[:, 7] = light_ids.astype(np.int32).view(np.float32)
    # vertex row: [n.xyz, tu, tv]
    vtx_geo = np.concatenate(
        [mesh.normals, mesh.texcoords], axis=1).astype(np.float32)

    # pre-joined shading row [mat, fn.xyz, light_id, n0.xyz, n1.xyz,
    # n2.xyz, uv0, uv1, uv2] (80 B/tri): one gather per surface element;
    # the same 4M-triangle gate as the JAX package, above which the
    # 4-gather path (tri_geo + 3 vtx_geo rows) serves
    tri_shade = None
    if len(idx4) <= 4_000_000:
        tri = idx4[:, :3]
        tri_shade = np.concatenate([
            tri_geo[:, 3:4],
            mesh.face_normals,
            tri_geo[:, 7:8],
            mesh.normals[tri[:, 0]],
            mesh.normals[tri[:, 1]],
            mesh.normals[tri[:, 2]],
            mesh.texcoords[tri[:, 0]],
            mesh.texcoords[tri[:, 1]],
            mesh.texcoords[tri[:, 2]],
        ], axis=1).astype(np.float32)

    out = {
        "bvh": bvh_to_device(bvh, device),
        "scene_lo": _to(mesh.vertices.min(0), device, torch.float32),
        "scene_hi": _to(mesh.vertices.max(0), device, torch.float32),
        "tri_geo": _to(tri_geo, device),
        "vtx_geo": _to(vtx_geo, device),
        "vertices": _to(mesh.vertices, device),
        "normals": _to(mesh.normals, device),
        "face_normals": _to(mesh.face_normals, device),
        "texcoords": _to(mesh.texcoords, device),
        "indices": _to(mesh.indices.reshape(-1, 4), device),
        "mat_table": mat_table,
        "lights": {k: _to(v, device) for k, v in lights.items()},
        "light_ids": _to(light_ids, device),
        "num_lights": num_lights,
        "max_path_len": max_path_len,
        # the scene's BSDF kinds: eval/sample compute only these lobes
        "mat_kinds": tuple(sorted({int(p["kind"]) for p in mat_params})),
    }
    if tri_shade is not None:
        out["tri_shade"] = _to(tri_shade, device)
    if tex_images:
        bank, hw = tx.build_bank(tex_images)
        out["textures"] = _to(bank, device)
        out["tex_hw"] = _to(hw, device)
    return out


def compile_obj(path, device, arity=8, max_path_len=64):
    """OBJ path -> CompiledScene on `device` (compiler.py:186-268). The
    (arity, max_path_len) choice plays the role of the converter flags
    baked into generated code (converter.cpp:973-1070). Texture files
    that do not exist are left out of the bank (their materials stay
    untextured), as in the reference."""
    f = obj_io.load_obj(path)
    mtl_lib = obj_io.load_mtl_libs(path, f)
    mtl_lib[""] = _dummy_material()

    # cleanup_obj: replace missing, dedup identical, drop unused
    names = list(f.materials)
    for i, n in enumerate(names):
        if n != "" and n not in mtl_lib:
            names[i] = ""
    remap_name = {}
    for i, n1 in enumerate(names):
        if n1 in remap_name:
            continue
        for n2 in names[i + 1:]:
            if n2 not in remap_name and n2 != n1 and _mat_eq(
                    mtl_lib[n1], mtl_lib[n2]):
                remap_name[n2] = n1
    used = set()
    for o in f.objects:
        for g in o.groups:
            for face in g.faces:
                n = names[face.material]
                used.add(remap_name.get(n, n))
    new_names = [n for n in dict.fromkeys(names) if n in used]
    id_remap = {}
    for old_id, n in enumerate(names):
        n = remap_name.get(n, n)
        # unused materials never appear on faces; map them anywhere
        id_remap[old_id] = new_names.index(n) if n in used else 0
    for o in f.objects:
        for g in o.groups:
            for face in g.faces:
                face.material = id_remap[face.material]
    mats = [mtl_lib[n] for n in new_names]

    mesh = obj_io.compute_tri_mesh(f)

    # texture bank from every referenced image file (converter.cpp
    # images map, :595-607)
    base = os.path.dirname(os.path.abspath(path))
    tex_files = []
    for m in mats:
        for name in (m.map_kd, m.map_ks, m.map_ke):
            if (name and name not in tex_files
                    and os.path.exists(os.path.join(base, name))):
                tex_files.append(name)
    tex_index = {n: i for i, n in enumerate(tex_files)}
    mat_params = [material_to_params(m, tex_index) for m in mats]

    # triangle lights from emissive materials; textured emission carries
    # the Ke texture id into the light table (converter.cpp:794-806)
    ke_table = np.asarray([p["ke"] for p in mat_params], np.float32)
    ke_tex_ids = [tex_index.get(m.map_ke, -1) for m in mats]
    emissive_tri = np.asarray(
        [mat_params[m]["emissive"] for m in mesh.tri_materials], bool)
    lights, light_ids = light_mod.build_light_table(
        mesh, ke_table, emissive_tri,
        ke_tex=ke_tex_ids if any(k >= 0 for k in ke_tex_ids) else None)
    num_lights = int((lights["kind"] == light_mod.TRIANGLE).sum()) or 1

    bvh = build_bvh(mesh.vertices, mesh.indices, arity=arity)
    tex_images = [tx.load_texture(os.path.join(base, n)) for n in tex_files]
    dev = _build_device(mesh, mat_params, lights, light_ids, bvh,
                        max_path_len, num_lights, device, tex_images)
    return CompiledScene(device=dev, mesh=mesh, materials=new_names,
                         mat_params=mat_params, num_lights=num_lights,
                         tex_files=tex_files)


_MESH_PALETTE = [
    (0.73, 0.70, 0.64), (0.62, 0.57, 0.50), (0.66, 0.24, 0.18),
    (0.25, 0.45, 0.22), (0.30, 0.33, 0.45), (0.60, 0.55, 0.35),
]


_EMITTER_FRAC = 0.30   # panel footprint as a fraction of the bbox xz extent
_EMITTER_POWER = 8.0   # panel radiance (compiler.py:354-359)


def compile_mesh(verts, indices, device, arity=8, max_path_len=64,
                 emitter="above", bvh_kwargs=None, materials=None,
                 tex_images=None, timings=None):
    """Procedural mesh -> CompiledScene on `device` (compiler.py:271-392):
    per-mat-id palette diffuse materials (or `materials`, obj Materials
    indexed by mat id), smooth area-weighted vertex normals, and one
    emissive area-light panel just under the bbox top (emitter="inside")
    or above it ("above"). tex_images: dict name -> linear (H, W, 3) f32
    image backing the materials' map_kd/map_ks names; its order sets the
    bank ids, and a textured scene gets triplanar uvs (procedural geometry
    ships none). timings, a dict, receives the seconds of the BVH build
    ("bvh_s") and of the whole compile ("total_s")."""
    t_start = time.perf_counter()
    verts = np.asarray(verts, np.float32)
    idx4 = np.asarray(indices, np.int32).reshape(-1, 4).copy()
    lo, hi = verts.min(0), verts.max(0)
    ext = hi - lo
    n_mats = int(idx4[:, 3].max()) + 1 if len(idx4) else 1

    # ---- emissive panel (2 tris, its own material id, normal -y) ----
    cx, cz = (lo[0] + hi[0]) / 2, (lo[2] + hi[2]) / 2
    hx, hz = ext[0] * _EMITTER_FRAC / 2, ext[2] * _EMITTER_FRAC / 2
    y = hi[1] - 0.04 * ext[1] if emitter == "inside" \
        else hi[1] + 0.10 * ext[1]
    pv = np.asarray([[cx - hx, y, cz - hz], [cx + hx, y, cz - hz],
                     [cx + hx, y, cz + hz], [cx - hx, y, cz + hz]],
                    np.float32)
    v0 = len(verts)
    panel = np.asarray([[v0 + 0, v0 + 1, v0 + 2, n_mats],
                        [v0 + 0, v0 + 2, v0 + 3, n_mats]], np.int32)
    verts = np.concatenate([verts, pv])
    idx4 = np.concatenate([idx4, panel])

    # ---- host mesh: smooth normals, face normals, zero uvs ----
    tri = idx4[:, :3]
    e1 = verts[tri[:, 1]] - verts[tri[:, 0]]
    e2 = verts[tri[:, 2]] - verts[tri[:, 0]]
    fn = np.cross(e1, e2)
    fl = np.linalg.norm(fn, axis=1, keepdims=True)
    fn_unit = fn / np.where(fl > 0, fl, 1)
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, tri[:, k], fn)  # area-weighted (obj.cpp:474-489)
    vl = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.where(vl > 0, vn / np.where(vl > 0, vl, 1),
                  np.asarray([0, 1, 0], np.float32))
    uv = np.zeros((len(verts), 2), np.float32)
    if tex_images:
        # triplanar projection: the two coordinates orthogonal to each
        # vertex normal's dominant axis, about 4 world units per tile
        ax = np.argmax(np.abs(vn), axis=1)
        u_axis = np.where(ax == 0, 1, 0)
        v_axis = np.where(ax == 2, 1, 2)
        uv = np.stack([verts[np.arange(len(verts)), u_axis],
                       verts[np.arange(len(verts)), v_axis]],
                      axis=1).astype(np.float32) * 0.25
    mesh = obj_io.TriMesh(
        vertices=verts.astype(np.float32),
        normals=vn.astype(np.float32),
        face_normals=fn_unit.astype(np.float32),
        texcoords=uv,
        indices=idx4.reshape(-1).astype(np.int32))

    # ---- materials: palette diffuse (or caller MTLs) + the emitter ----
    if materials is not None:
        if len(materials) < n_mats:
            raise ValueError(f"scene uses {n_mats} material ids, got "
                             f"{len(materials)}")
        mats = list(materials[:n_mats])
    else:
        mats = [obj_io.Material(name=f"m{i}",
                                kd=_MESH_PALETTE[i % len(_MESH_PALETTE)])
                for i in range(n_mats)]
    mats.append(obj_io.Material(name="emitter", ke=(_EMITTER_POWER,) * 3))
    tex_files = list(tex_images) if tex_images else []
    tex_index = {n: i for i, n in enumerate(tex_files)}
    mat_params = [material_to_params(m, tex_index) for m in mats]

    ke_table = np.asarray([p["ke"] for p in mat_params], np.float32)
    emissive_tri = np.asarray(
        [mat_params[m]["emissive"] for m in mesh.tri_materials], bool)
    lights, light_ids = light_mod.build_light_table(
        mesh, ke_table, emissive_tri)
    num_lights = int((lights["kind"] == light_mod.TRIANGLE).sum()) or 1

    t_bvh = time.perf_counter()
    bvh = build_bvh(mesh.vertices, mesh.indices, arity=arity,
                    **(bvh_kwargs or {}))
    t_bvh = time.perf_counter() - t_bvh
    dev = _build_device(mesh, mat_params, lights, light_ids, bvh,
                        max_path_len, num_lights, device,
                        [tex_images[n] for n in tex_files])
    if timings is not None:
        timings["bvh_s"] = t_bvh
        timings["total_s"] = time.perf_counter() - t_start
    return CompiledScene(device=dev, mesh=mesh,
                         materials=[m.name for m in mats],
                         mat_params=mat_params, num_lights=num_lights,
                         tex_files=tex_files)


def load_data_dir(data_dir, device):
    """A converter-written data/ directory -> CompiledScene on `device`
    (compiler.py:395-505). The generated main.impala loads every data/*.bin
    buffer and the BVH (converter.cpp:664-680, interface.cpp:432-454);
    scene.json stands for the generated code's constants. Equal to
    compile_obj's tables for the same OBJ, tensor for tensor; the light
    buffers carry no emission-texture columns, as the converter writes
    none."""
    with open(os.path.join(data_dir, "scene.json")) as f:
        program = json.load(f)
    cols = 4 if program.get("padded_vec3", False) else 3

    def read(name, dtype=np.float32):
        return formats.read_lz4_buffer(os.path.join(data_dir, name), dtype)

    def rvec3(name):
        return np.ascontiguousarray(read(name).reshape(-1, cols)[:, :3])

    mesh = obj_io.TriMesh(
        vertices=rvec3("vertices.bin"), normals=rvec3("normals.bin"),
        face_normals=rvec3("face_normals.bin"),
        texcoords=read("texcoords.bin").reshape(-1, 2),
        indices=read("indices.bin", np.int32))

    light_ids = read("light_ids.bin", np.int32)
    if os.path.exists(os.path.join(data_dir, "light_verts.bin")):
        lv = rvec3("light_verts.bin").reshape(-1, 3, 3)
        inv_area = read("light_areas.bin")
        lights = {
            "kind": np.full(len(inv_area), light_mod.TRIANGLE, np.int32),
            "v0": np.ascontiguousarray(lv[:, 0]),
            "v1": np.ascontiguousarray(lv[:, 1]),
            "v2": np.ascontiguousarray(lv[:, 2]),
            "n": rvec3("light_norms.bin"),
            "inv_area": inv_area,
            "color": rvec3("light_colors.bin"),
        }
    else:
        # dummy black point light (converter.cpp:848-850)
        lights = {
            "kind": np.zeros(1, np.int32),
            "v0": np.zeros((1, 3), np.float32),
            "v1": np.zeros((1, 3), np.float32),
            "v2": np.zeros((1, 3), np.float32),
            "n": np.asarray([[0, 0, 1]], np.float32),
            "inv_area": np.ones(1, np.float32),
            "color": np.zeros((1, 3), np.float32),
        }

    # bvh.bin: [u32 node_bytes][u32 tri_bytes][lz4 nodes][lz4 tris]
    # (converter.cpp:428-438, interface.cpp:432-454)
    with open(os.path.join(data_dir, "bvh.bin"), "rb") as f:
        node_bytes, tri_bytes = struct.unpack("<II", f.read(8))
        raw_nodes = formats.read_lz4_buffer(f)
        raw_tris = formats.read_lz4_buffer(f)
    arity = {64: 2, 128: 4, 256: 8}[node_bytes]
    ndt = formats.node_dtype(arity)
    tdt = formats.TRI1_DTYPE if arity == 2 else formats.TRI4_DTYPE
    if (ndt.itemsize, tdt.itemsize) != (node_bytes, tri_bytes):
        raise ValueError(f"{data_dir}/bvh.bin: record sizes {node_bytes}, "
                         f"{tri_bytes} do not match BVH{arity}")
    btype = {2: formats.BVH2_TRI1, 4: formats.BVH4_TRI4,
             8: formats.BVH8_TRI4}[arity]
    bvh = WideBvh.from_block(formats.BvhBlock(
        btype, np.frombuffer(raw_nodes.tobytes(), ndt),
        np.frombuffer(raw_tris.tobytes(), tdt)))

    names, mat_params = [], []
    for m in program["materials"]:
        names.append(m["name"])
        mat_params.append({k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in m.items() if k != "name"})
    tex_files = program.get("textures", [])
    tex_images = [tx.load_texture(os.path.join(data_dir, "textures", n))
                  for n in tex_files]
    # the same `or 1` floor as compile_obj: a lightless scene keeps the
    # dummy black light, so pick_uniform never takes a modulo by zero
    num_lights = program["num_lights"] or 1
    dev = _build_device(mesh, mat_params, lights, light_ids, bvh,
                        program["max_path_len"], num_lights, device,
                        tex_images)
    return CompiledScene(device=dev, mesh=mesh, materials=names,
                         mat_params=mat_params, num_lights=num_lights,
                         tex_files=tex_files)


# the JAX package's VMEM budget; the fast-memory size the tier rule uses
# for tables that lie on the CPU, so CPU runs pick the JAX package's tiers
_CPU_FAST_BYTES = 80 * 1024 * 1024


def fast_memory_bytes(device):
    """The fast memory the tier rule measures a scene against: on a CUDA
    card its L2 cache (50 MB on an H100), where the TPU's VMEM stood; for
    tables on the CPU, the JAX package's 80 MiB VMEM budget."""
    d = device["bvh"]["nodes"].device
    if d.type == "cuda":
        return torch.cuda.get_device_properties(d).L2_cache_size
    return _CPU_FAST_BYTES


def _table_bytes(device):
    bvh = device["bvh"]
    return bvh["nodes"].numel() * 4, bvh["tris"].numel() * 4


def packet_ok(device, limit_bytes=None):
    """True when the scene's BVH tables fit the fast memory
    (compiler.py:508)."""
    if limit_bytes is None:
        limit_bytes = fast_memory_bytes(device)
    return sum(_table_bytes(device)) <= limit_bytes


def packet_mode(device, limit_bytes=None):
    """The scene's tier (compiler.py:515-533): "dense" (a few Tri
    packets), "hybrid" (both tables fit the fast memory), "hybrid-hbm"
    (the node table fits, the Tri table does not: San-Miguel-class) or
    "hybrid-giga" (neither fits). limit_bytes defaults to
    fast_memory_bytes: the L2 size on a card."""
    if limit_bytes is None:
        limit_bytes = fast_memory_bytes(device)
    nodes_b, tris_b = _table_bytes(device)
    if device["bvh"]["tris"].shape[0] <= DENSE_MAX_PACKETS:
        return "dense"
    if nodes_b + tris_b <= limit_bytes:
        return "hybrid"
    if nodes_b <= limit_bytes:
        return "hybrid-hbm"
    return "hybrid-giga"


def select_packet(device, limit_bytes=None):
    """The single-call traversal policy (compiler.py:536-550), TPU branch:
    dense scenes go to the packet kernel, every other tier keeps
    packet_mode's word, which integrator._traverse maps onto K1 ("hybrid")
    or K2 ("hybrid-hbm", "hybrid-giga"). The JAX package's CPU branch
    sends dense scenes to the dense engine (packet="dense",
    traversal/dense.py); the port keeps K1 for them until a measurement on
    the card says otherwise (chip_smoke.py phase 16 times both)."""
    mode = packet_mode(device, limit_bytes=limit_bytes)
    return True if mode == "dense" else mode


def shell_coverage(device):
    """Fraction of the scene-bbox shell covered by geometry lying within
    2.5% of a shell face (compiler.py:553-580): near 1 for enclosed
    interiors (hall-class), about 1/6 for open scenes (crown-class). A
    host-side statistic, computed once per scene."""
    v = device["vertices"].cpu().numpy()
    i4 = device["indices"].cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    ext = np.maximum(hi - lo, 1e-6)
    tri = v[i4[:, :3]]                     # (T, 3, 3)
    cen = tri.mean(1)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    cover = 0.0
    for ax in range(3):
        o1, o2 = (ax + 1) % 3, (ax + 2) % 3
        face_area = ext[o1] * ext[o2]
        for plane in (lo[ax], hi[ax]):
            near = np.abs(cen[:, ax] - plane) < 0.025 * ext[ax]
            cover += min(float(area[near].sum()) / face_area, 1.0)
    return cover / 6.0


def select_render_policy(device, limit_bytes=None):
    """kwargs for render_iteration_persistent by tier: the TPU branch of
    compiler.py:583-630.

    - dense: packet=True, retire_every=2 (the TPU's packet kernel on
      cornell-class scenes; the JAX CPU branch takes packet="dense");
    - hybrid (tables fit L2): packet=True, with the shell_coverage pool
      rule (a 64K pool for enclosed interiors). The TPU sends this tier to
      the dual-queue engine with staged compaction (packet=False,
      compact=5, traversal/tiled.py), which spares its bounce rays the
      packet kernel's tile-union tax; K1 keeps one stack per ray and pays
      no such tax, so the port keeps K1 until the card's numbers say
      otherwise (chip_smoke.py phase 16 times the dual-queue engine
      against K1 on hall);
    - hbm / giga (San-Miguel-class, the Tri table exceeds L2): the
      prefetching kernel K2 with the pool sort, packet="hbm" or "giga"."""
    mode = packet_mode(device, limit_bytes=limit_bytes)
    if mode == "dense":
        return dict(packet=True, retire_every=2)
    if mode == "hybrid":
        pol = dict(packet=True)
        if shell_coverage(device) >= 0.5:
            pol["pool"] = 1 << 16
        return pol
    return dict(packet=mode[len("hybrid-"):], sort="pool")


def from_jax_device(np_tree, device):
    """A JAX CompiledScene.device whose array leaves went through
    np.asarray -> the port's device dict on `device`. The JAX package's
    static nodes are read by duck typing (BvhMeta's stack sizes,
    KindSet's `kinds`), so nothing here imports jax. Texture banks and
    textured light columns are arrays like the others."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _to(np.asarray(x), device)

    out = {}
    for key, val in np_tree.items():
        if key in ("num_lights", "max_path_len"):
            out[key] = int(val)
        elif key == "mat_kinds":
            out[key] = tuple(int(k) for k in getattr(val, "kinds", val))
        elif key == "bvh":
            meta = val["meta"]
            out[key] = {"nodes": conv(val["nodes"]),
                        "tris": conv(val["tris"]),
                        "meta": BvhMeta(shared_stack=int(meta.shared_stack),
                                        node_stack=int(meta.node_stack))}
        else:
            out[key] = conv(val)
    return out
