"""OBJ/MTL loader + triangle-mesh builder (copy of rodent_tpu/io/obj.py).

Re-implements the behavior of the reference's src/driver/obj.cpp /
obj.h: negative-index handling, fan triangulation, per-(v,t,n) vertex
dedup with per-object index offsets, the 4-ints-per-triangle index
convention (v0, v1, v2, material_id), face/vertex normal computation, and
degenerate-normal fixup (obj.cpp:412-511).

This is the host-side scene ingestion path; performance-critical scenes can
use the C++ loader in rodent_tpu_torch/native (same semantics).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Material:
    name: str = ""
    ka: tuple = (0.0, 0.0, 0.0)
    kd: tuple = (0.0, 0.0, 0.0)
    ks: tuple = (0.0, 0.0, 0.0)
    ke: tuple = (0.0, 0.0, 0.0)
    ns: float = 1.0
    ni: float = 1.0
    tf: tuple = (0.0, 0.0, 0.0)
    d: float = 1.0
    illum: int = 2
    map_kd: str = ""
    map_ks: str = ""
    map_ke: str = ""
    map_bump: str = ""
    map_d: str = ""


@dataclass
class Face:
    indices: list  # list of (v, t, n) 0-based-resolved tuples
    material: int


@dataclass
class Group:
    faces: list = field(default_factory=list)


@dataclass
class Object:
    groups: list = field(default_factory=list)


@dataclass
class File:
    objects: list = field(default_factory=list)
    vertices: np.ndarray = None     # (V, 3) f32, slot 0 reserved like the ref
    normals: np.ndarray = None      # (N, 3) f32
    texcoords: np.ndarray = None    # (T, 2) f32
    materials: list = field(default_factory=list)  # material names, [0] = ""
    mtl_libs: list = field(default_factory=list)


@dataclass
class TriMesh:
    """Unified mesh; indices is flat int32, 4 per triangle:
    (v0, v1, v2, material_id) — matching obj.cpp compute_tri_mesh."""
    vertices: np.ndarray      # (V, 3) f32
    normals: np.ndarray       # (V, 3) f32 (smooth, normalized)
    face_normals: np.ndarray  # (T, 3) f32
    texcoords: np.ndarray     # (V, 2) f32
    indices: np.ndarray       # (T*4,) i32

    @property
    def num_tris(self):
        return len(self.indices) // 4

    @property
    def tri_indices(self):
        return self.indices.reshape(-1, 4)[:, :3]

    @property
    def tri_materials(self):
        return self.indices.reshape(-1, 4)[:, 3]


def _parse_floats(parts, n, default=0.0):
    out = [default] * n
    for i in range(min(n, len(parts))):
        out[i] = float(parts[i])
    return out


def load_obj(path):
    """Parses an OBJ file. Mirrors obj.cpp load_obj: slot 0 of each index
    stream is a dummy so OBJ's 1-based indices map directly; negative
    indices are resolved relative to the current stream size."""
    vertices = [(0.0, 0.0, 0.0)]
    normals = [(0.0, 0.0, 0.0)]
    texcoords = [(0.0, 0.0)]
    f = File()
    f.materials = [""]
    mat_index = {"": 0}
    cur_material = 0
    cur_object = Object()
    cur_object.groups.append(Group())
    f.objects.append(cur_object)

    def cur_group():
        return f.objects[-1].groups[-1]

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                vertices.append(tuple(_parse_floats(parts[1:], 3)))
            elif tag == "vn":
                normals.append(tuple(_parse_floats(parts[1:], 3)))
            elif tag == "vt":
                texcoords.append(tuple(_parse_floats(parts[1:], 2)))
            elif tag == "f":
                idx = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    v = int(comps[0]) if comps[0] else 0
                    t = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    n = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    if v < 0:
                        v += len(vertices)
                    if t < 0:
                        t += len(texcoords)
                    if n < 0:
                        n += len(normals)
                    idx.append((v, t, n))
                if len(idx) >= 3:
                    cur_group().faces.append(Face(idx, cur_material))
            elif tag == "g" or tag == "s":
                f.objects[-1].groups.append(Group())
            elif tag == "o":
                obj = Object()
                obj.groups.append(Group())
                f.objects.append(obj)
            elif tag == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                if name not in mat_index:
                    mat_index[name] = len(f.materials)
                    f.materials.append(name)
                cur_material = mat_index[name]
            elif tag == "mtllib":
                f.mtl_libs.append(" ".join(parts[1:]))

    f.vertices = np.asarray(vertices, np.float32)
    f.normals = np.asarray(normals, np.float32)
    f.texcoords = np.asarray(texcoords, np.float32)
    return f


def load_mtl(path, mtl_lib=None):
    """Parses an MTL file into {name: Material} (obj.cpp parse_mtl)."""
    if mtl_lib is None:
        mtl_lib = {}
    cur = None
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if "#" in line:
                line = line[:line.index("#")]
            parts = line.strip().split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "newmtl":
                cur = Material(name=parts[1] if len(parts) > 1 else "")
                mtl_lib[cur.name] = cur
            elif cur is None:
                continue
            elif tag == "Ka":
                cur.ka = tuple(_parse_floats(parts[1:], 3))
            elif tag == "Kd":
                cur.kd = tuple(_parse_floats(parts[1:], 3))
            elif tag == "Ks":
                cur.ks = tuple(_parse_floats(parts[1:], 3))
            elif tag == "Ke":
                cur.ke = tuple(_parse_floats(parts[1:], 3))
            elif tag == "Ns":
                cur.ns = float(parts[1])
            elif tag == "Ni":
                cur.ni = float(parts[1])
            elif tag == "Tf":
                cur.tf = tuple(_parse_floats(parts[1:], 3))
            elif tag == "d":
                cur.d = float(parts[1])
            elif tag == "illum":
                cur.illum = int(parts[1])
            elif tag == "map_Kd":
                cur.map_kd = parts[-1]
            elif tag == "map_Ks":
                cur.map_ks = parts[-1]
            elif tag == "map_Ke":
                cur.map_ke = parts[-1]
            elif tag in ("map_bump", "bump"):
                cur.map_bump = parts[-1]
            elif tag == "map_d":
                cur.map_d = parts[-1]
    return mtl_lib


def load_mtl_libs(obj_path, obj_file):
    base = os.path.dirname(os.path.abspath(obj_path))
    mtl_lib = {}
    for lib in obj_file.mtl_libs:
        p = os.path.join(base, lib)
        if os.path.exists(p):
            load_mtl(p, mtl_lib)
    return mtl_lib


def compute_tri_mesh(obj_file, mtl_offset=0):
    """Builds the unified TriMesh exactly like obj.cpp:412-511:
    per-object vertex dedup by (v, t, n) triple, fan triangulation,
    4-int index stream, smooth normals when absent, degenerate fixup."""
    all_vertices, all_normals, all_texcoords = [], [], []
    all_indices = []
    all_face_normals = []

    for obj in obj_file.objects:
        mapping = {}
        triangles = []
        has_normals = False
        has_texcoords = False
        for group in obj.groups:
            for face in group.faces:
                for ind in face.indices:
                    if ind not in mapping:
                        has_normals |= ind[2] != 0
                        has_texcoords |= ind[1] != 0
                        mapping[ind] = len(mapping)
                v0 = mapping[face.indices[0]]
                prev = mapping[face.indices[1]]
                for i in range(1, len(face.indices) - 1):
                    nxt = mapping[face.indices[i + 1]]
                    triangles.append((v0, prev, nxt, face.material + mtl_offset))
                    prev = nxt
        if not triangles:
            continue

        vtx_offset = sum(len(v) for v in all_vertices)
        tri = np.asarray(triangles, np.int64)
        idx = np.empty((len(triangles), 4), np.int32)
        idx[:, 0] = tri[:, 0] + vtx_offset
        idx[:, 1] = tri[:, 1] + vtx_offset
        idx[:, 2] = tri[:, 2] + vtx_offset
        idx[:, 3] = tri[:, 3]
        all_indices.append(idx.reshape(-1))

        nvert = len(mapping)
        verts = np.zeros((nvert, 3), np.float32)
        texs = np.zeros((nvert, 2), np.float32)
        norms = np.zeros((nvert, 3), np.float32)
        inds = np.asarray(list(mapping.keys()), np.int64)
        slots = np.asarray(list(mapping.values()), np.int64)
        verts[slots] = obj_file.vertices[inds[:, 0]]
        if has_texcoords:
            texs[slots] = obj_file.texcoords[inds[:, 1]]

        v0 = verts[tri[:, 0]]
        v1 = verts[tri[:, 1]]
        v2 = verts[tri[:, 2]]
        fn = np.cross(v1 - v0, v2 - v0)
        fn_len = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.maximum(fn_len, 1e-30)
        all_face_normals.append(fn.astype(np.float32))

        if has_normals:
            norms[slots] = obj_file.normals[inds[:, 2]]
        else:
            for c in range(3):
                np.add.at(norms, tri[:, c], fn)

        all_vertices.append(verts)
        all_normals.append(norms)
        all_texcoords.append(texs)

    vertices = np.concatenate(all_vertices) if all_vertices else np.zeros((0, 3), np.float32)
    normals = np.concatenate(all_normals) if all_normals else np.zeros((0, 3), np.float32)
    texcoords = np.concatenate(all_texcoords) if all_texcoords else np.zeros((0, 2), np.float32)
    indices = np.concatenate(all_indices) if all_indices else np.zeros((0,), np.int32)
    face_normals = np.concatenate(all_face_normals) if all_face_normals else np.zeros((0, 3), np.float32)

    # Degenerate-normal fixup (obj.cpp:495-508)
    len2 = np.sum(normals * normals, axis=-1)
    bad = (len2 <= np.finfo(np.float32).eps) | ~np.isfinite(len2)
    normals = np.where(bad[:, None], np.asarray([0.0, 1.0, 0.0], np.float32),
                       normals / np.sqrt(np.maximum(len2, 1e-30))[:, None])

    return TriMesh(vertices=vertices, normals=normals.astype(np.float32),
                   face_normals=face_normals, texcoords=texcoords,
                   indices=indices)


def load_scene_mesh(path, prefer_native=True):
    """Convenience: OBJ path -> (TriMesh, material name list, mtl_lib).

    Uses the C++ loader (native/obj_loader.cpp, the obj.cpp:412-511
    role) — ~100x the Python parser, required for San-Miguel-class
    scenes — unless prefer_native=False or the file cannot be read, then
    the pure-Python path.
    Both produce identical vertices/indices (normals within 1 ulp)."""
    if prefer_native:
        from .. import native
        out = native.obj_load(path)
        if out is not None:
            verts, norms, texs, fnorm, idx, names, libs = out
            base = os.path.dirname(os.path.abspath(path))
            mtl_lib = {}
            for lib in libs:
                p = os.path.join(base, lib)
                if os.path.exists(p):
                    load_mtl(p, mtl_lib)
            mesh = TriMesh(vertices=verts, normals=norms,
                           face_normals=fnorm, texcoords=texs,
                           indices=idx)
            return mesh, names, mtl_lib
    f = load_obj(path)
    mtl_lib = load_mtl_libs(path, f)
    mesh = compute_tri_mesh(f)
    return mesh, f.materials, mtl_lib
